"""The KDA recurrence's kernel (``ops/csrc/kda.cu`` of the port) in a traced
article encode-then-rank unit: its operations and bytes, counted in a fixed
chunk-64 form whatever chunk the kernel takes, over the real tokens of every
KDA layer's batches (the port's counter ``kda.tokens_real``: the kernel
computes no chunk past a row's length, so the pads that ``kda.tokens_computed``
counts are work these inputs do not need), its share of its roofline and of
the unit's busy device time. A launch is the kernel's where its kernel name
holds ``KERNEL``."""

from __future__ import annotations

from portbench.spans import recorded
from portbench.work import roofline_share

KERNEL = "kda_chunked"
CHUNK = 64
# The kernel multiplies TF32 operands (the float32 row of peaks.json) into a
# float32 state.
PEAK_DTYPE = "float32"


def recurrence_macs(heads: int, dk: int, dv: int, chunk: int = CHUNK) -> float:
    """Multiply-adds a token of the recurrence in chunks of ``chunk``: per
    head the state's three products (W_k S, the decayed q times S, and the
    state's update: 3 dk dv), the chunk's pair products with decay (A and
    P: 2 chunk dk), the triangular solve's products ((I + A)^-1 times the
    decayed k and v: chunk (dk + dv)) and P U (chunk dv)."""
    return float(heads) * (3 * dk * dv + chunk * (3 * dk + 2 * dv))


def kda_work(hf: dict, tokens: float) -> tuple[float, float]:
    """(operations, bytes) of the recurrence over ``tokens`` token-layers:
    twice its multiply-adds; q, k, v (bf16), log alpha (float32) and beta
    (float32 a head) read once, o (bf16) written once."""
    lac = hf["linear_attn_config"]
    h, hd = lac["num_heads"], lac["head_dim"]
    ops = 2.0 * recurrence_macs(h, hd, hd) * tokens
    per_token = 3 * h * hd * 2 + h * hd * 4 + h * 4 + h * hd * 2
    return ops, per_token * tokens


def _readings(r):
    """The traced unit's token-layers and the kernel's device seconds;
    ``None`` outside a traced ``article_encode_eval`` unit or without them."""
    if r.kind != "article_encode_eval" or r.trace is None:
        return None
    rec = recorded()
    if not rec:
        return None
    tokens = rec.counters.get("kda.tokens_real", 0)
    seconds = r.trace.seconds(KERNEL)
    if tokens <= 0 or seconds <= 0:
        return None
    return tokens, seconds


def roofline(r) -> float | None:
    got = _readings(r)
    if got is None:
        return None
    ops, nbytes = kda_work(r.cell.config, got[0])
    return roofline_share(ops, nbytes, got[1], PEAK_DTYPE)


def share(r) -> float | None:
    got = _readings(r)
    if got is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * got[1] / r.trace.busy_s
