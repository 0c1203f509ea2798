"""``encode.pad_share.encode_eval``: the percent of the tokens that the traced unit's encode computed which were padding (each row to its bucket's width, and the pad rows that fill a bucket's last batch), from the port's counters: ``100 x (encode.tokens_computed - encode.tokens_real) / encode.tokens_computed``."""

from portbench.spans import pad_share


def read(r):
    return pad_share(r, "encode_eval", "encode")
