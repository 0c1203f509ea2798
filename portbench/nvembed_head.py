"""NV-Embed's pooling head in a traced encode-then-rank unit: its kernels'
share of their roofline. The head and the user tower run the same two
kernels, the head in the encoder's 16-bit type and the tower in float32, so
a launch is the head's where the instantiation in its kernel name is 16-bit
(``__nv_bfloat16``, ``__half``). The work is ``work.py``'s formulas at the
head's widths over the real tokens of both tables."""

from __future__ import annotations

from portbench.reference import nvembed
from portbench.work import roofline_share

TYPE_NAMES = {"bfloat16": "bfloat16", "float16": "__half"}


def head_widths(cfg: dict) -> dict:
    """The head as ``work.py`` reads a tower: its heads, latents, head width,
    model width, GEGLU width and compute type."""
    w = nvembed.widths(cfg["encoder"])
    return {
        "num_heads": w["pool_heads"], "num_latents": w["latents"], "latent_dim_head": w["pool_dh"],
        "reduced_dim": w["d"], "hidden_dim": nvembed.FF_MULT * w["d"],
        "compute_dtype": cfg["encoder_dtype"]["compute_dtype"],
    }


def roofline(r, kernel: str, work) -> float | None:
    """The head's launches of the kernels whose names hold ``kernel``, as a
    percent of their roofline (``work``: ``work.latent_attention_work`` or
    ``work.geglu_work``); ``None`` outside a traced ``encode_eval`` unit."""
    if r.kind != "encode_eval" or r.trace is None:
        return None
    c = r.counters["traced"]
    if not c.get("head_calls"):
        return None
    head = head_widths(r.cell.config)
    ops, nbytes = work(head, c["head_tokens"], int(c["head_calls"]))
    typed = [k for k in r.trace.kernel_s if kernel in k and TYPE_NAMES[head["compute_dtype"]] in k]
    return roofline_share(ops, nbytes, sum(r.trace.kernel_s[k] for k in typed), head["compute_dtype"])
