"""``trainer.build_share.train``: the seconds the prefetch thread spent building batches (the port's spans ``train.build_batch``: the epoch's pair sampling, the index arrays, the pinning) as a percent of the traced epoch (``train.epoch``). Near 100 the producer paces the loop."""

from portbench.spans import span_share


def read(r):
    return span_share(r, "train", "train.build_batch", "train.epoch")
