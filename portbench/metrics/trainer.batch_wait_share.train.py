"""``trainer.batch_wait_share.train``: the percent of the traced epoch (the port's span ``train.epoch``) that the training loop spent blocked on the prefetch queue for its next batch (the spans ``train.wait_batch``)."""

from portbench.spans import span_share


def read(r):
    return span_share(r, "train", "train.wait_batch", "train.epoch")
