"""Operations and bytes of the port's hand-written kernels, from the
configuration's widths and the real tokens of the work (padding is not
counted), and the share of a roofline or a peak."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def latent_attention_work(tower: dict, tokens: float, calls: int) -> tuple[float, float]:
    """(operations, bytes) of the latent cross-attention over ``tokens``
    queries in ``calls`` launches: q read and the output written once a
    token, the latents' k and v read once a launch."""
    heads, n, dh = tower["num_heads"], tower["num_latents"], tower["latent_dim_head"]
    es = ELEMENT_BYTES[tower["compute_dtype"]]
    return 4.0 * heads * n * dh * tokens, (2.0 * heads * dh * tokens + 2.0 * heads * n * dh * calls) * es


def geglu_work(tower: dict, tokens: float, calls: int) -> tuple[float, float]:
    """(operations, bytes) of the GEGLU feed-forward over ``tokens`` rows in
    ``calls`` calls: x read and the float32 output written once a token,
    both weights and biases read once a call."""
    d, f = tower["reduced_dim"], tower["hidden_dim"]
    es = ELEMENT_BYTES[tower["compute_dtype"]]
    return 6.0 * d * f * tokens, (d * tokens + calls * (3.0 * d * f + 2.0 * f + d)) * es + 4.0 * d * tokens


def cosine_flops(dim: int, scores: float) -> float:
    """A cosine score: the dot product and the candidate's norm."""
    return 4.0 * dim * scores


def roofline_share(ops: float, nbytes: float, seconds: float, dtype: str) -> float | None:
    """Percent of the roofline: the least time the card could take (the
    larger of operations over the peak and bytes over the bandwidth) over
    the kernel's device time."""
    if seconds <= 0 or ops <= 0:
        return None
    least = max(ops / PEAKS["flops_per_s"][dtype], nbytes / PEAKS["bytes_per_s"])
    return 100.0 * least / seconds


def peak_share(flops: float, seconds: float, dtype: str) -> float | None:
    """Percent of the compute type's peak."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAKS["flops_per_s"][dtype]
