"""``eval.pad_share.eval``: the percent of the history tokens that the traced ``evaluate()`` computed which were padding (the last chunk's fill), from the port's counters: ``100 x (eval.tokens_computed - eval.tokens_real) / eval.tokens_computed``."""

from portbench.spans import pad_share


def read(r):
    return pad_share(r, "eval", "eval")
