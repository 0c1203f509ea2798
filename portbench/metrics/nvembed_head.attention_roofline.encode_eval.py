"""``nvembed_head.attention_roofline.encode_eval``: the latent cross-attention kernel's 16-bit launches (NV-Embed's head: 512 latents, 8 heads of 4,096) as a percent of their roofline over the traced unit: the least time the card could take for the head's work over the real tokens of both tables (``work.latent_attention_work`` at the head's widths), over the device time of every launch whose kernel name holds ``latent_attention_kernel`` and the 16-bit type (``portbench/nvembed_head.py``; the tower's float32 launches are left out)."""

from portbench.nvembed_head import roofline
from portbench.work import latent_attention_work


def read(r):
    return roofline(r, "latent_attention_kernel", latent_attention_work)
