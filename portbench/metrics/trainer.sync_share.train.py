"""``trainer.sync_share.train``: the percent of the traced epoch (the port's span ``train.epoch``) that the host spent blocked on the device for the loss (the spans ``train.loss_fetch``: each step's fetch and the epoch's last)."""

from portbench.spans import span_share


def read(r):
    return span_share(r, "train", "train.loss_fetch", "train.epoch")
