"""``train.pad_share.train``: the percent of the history tokens that the traced epoch's steps computed which were padding, from the port's counters: ``100 x (train.tokens_computed - train.tokens_real) / train.tokens_computed`` (flat step: the stream's real tokens against its power-of-two length; padded step: the mask's sum against ``B x L``)."""

from portbench.spans import pad_share


def read(r):
    return pad_share(r, "train", "train")
