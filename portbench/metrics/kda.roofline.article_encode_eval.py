"""``kda.roofline.article_encode_eval``: the KDA recurrence's kernel (every launch whose kernel name holds ``kda_chunked``) as a percent of its roofline over the traced unit: the least time the card could take for its work (``portbench/kda.py``: the port's counter ``kda.tokens_real`` in a fixed chunk-64 form (the kernel computes no chunk past a row's length), TF32 products; q, k, v, log alpha and beta read once, o written once), over its device time."""

from portbench.kda import roofline


def read(r):
    return roofline(r)
