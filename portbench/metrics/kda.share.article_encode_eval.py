"""``kda.share.article_encode_eval``: the KDA recurrence's kernel's device time (every launch whose kernel name holds ``kda_chunked``) as a percent of the traced article encode-then-rank unit's busy device time."""

from portbench.kda import share


def read(r):
    return share(r)
