"""The routed experts' grouped kernels (``ops/csrc/moe_experts.cu`` of the
port) in a traced encode-then-rank unit: their operations and bytes from the
configuration's widths and the port's counters, their share of their
roofline and of the unit's busy device time. A launch is theirs where its
kernel name holds ``KERNEL``."""

from __future__ import annotations

from portbench.spans import recorded
from portbench.work import roofline_share

KERNEL = "moe_experts_"


def experts_work(hf: dict, assignments: float, launches: int) -> tuple[float, float]:
    """(operations, bytes) of the routed experts over ``assignments``
    token-expert pairs in ``launches`` launches (a gate-up and a down for
    each MoE layer of each batch): per pair the gate, up and down products
    (2 x 3 x D x I); each launch reads every expert's weights of its pass
    once (gate-up 2·E·I·D, down E·D·I bf16 values); per pair the gate-up
    reads its row (D) and writes h (I) in bf16, the down reads h and its
    weight (float32) and writes its float32 output row (D)."""
    d, i, e = hf["hidden_size"], hf["moe_intermediate_size"], hf["n_routed_experts"]
    ops = 2.0 * 3 * d * i * assignments
    weights = launches / 2 * 3.0 * e * i * d * 2
    rows = assignments * ((d + i) * 2 + i * 2 + 4 + d * 4)
    return ops, weights + rows


def _readings(r):
    """The traced unit's pairs and launches, and the kernels' device seconds;
    ``None`` outside a traced ``moe_encode_eval`` unit or without them."""
    if r.kind != "moe_encode_eval" or r.trace is None:
        return None
    rec = recorded()
    if not rec:
        return None
    pairs, launches = rec.counters.get("moe.assignments", 0), rec.counters.get("moe.grouped_launches", 0)
    seconds = r.trace.seconds(KERNEL)
    if pairs <= 0 or launches <= 0 or seconds <= 0:
        return None
    return pairs, launches, seconds


def roofline(r) -> float | None:
    got = _readings(r)
    if got is None:
        return None
    pairs, launches, seconds = got
    ops, nbytes = experts_work(r.cell.config, pairs, launches)
    return roofline_share(ops, nbytes, seconds, "bfloat16")


def share(r) -> float | None:
    got = _readings(r)
    if got is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * got[2] / r.trace.busy_s
