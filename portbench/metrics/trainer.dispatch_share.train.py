"""``trainer.dispatch_share.train``: the percent of the traced epoch (the port's span ``train.epoch``) that the host spent queuing steps (the spans ``train.step``: the batch's copies to the device, forward, backward and the optimizer, launched)."""

from portbench.spans import span_share


def read(r):
    return span_share(r, "train", "train.step", "train.epoch")
