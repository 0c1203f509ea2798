"""``moe_experts.share.moe_encode_eval``: the routed experts' grouped kernels' device time (every launch whose kernel name holds ``moe_experts_``) as a percent of the traced encode-then-rank unit's busy device time."""

from portbench.moe_experts import share


def read(r):
    return share(r)
