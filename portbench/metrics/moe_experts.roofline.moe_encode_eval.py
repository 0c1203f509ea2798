"""``moe_experts.roofline.moe_encode_eval``: the routed experts' grouped kernels (every launch whose kernel name holds ``moe_experts_``) as a percent of their roofline over the traced unit: the least time the card could take for their work (``portbench/moe_experts.py``: the port's counter ``moe.assignments`` x 2 x 3 x 2,048 x 1,408 operations; every expert's weights once a launch of ``moe.grouped_launches``, the rows in and out), over their device time."""

from portbench.moe_experts import roofline


def read(r):
    return roofline(r)
