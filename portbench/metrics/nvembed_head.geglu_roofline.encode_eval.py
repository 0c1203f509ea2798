"""``nvembed_head.geglu_roofline.encode_eval``: the GEGLU feed-forward kernels' 16-bit launches (NV-Embed's head: 4,096 -> 2 x 16,384 -> 4,096) as a percent of their roofline over the traced unit: the least time the card could take for the head's work over the real tokens of both tables (``work.geglu_work`` at the head's widths), over the device time of every launch whose kernel name holds ``geglu_`` and the 16-bit type (``portbench/nvembed_head.py``; the tower's float32 launches are left out)."""

from portbench.nvembed_head import roofline
from portbench.work import geglu_work


def read(r):
    return roofline(r, "geglu_", geglu_work)
