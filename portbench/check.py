"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out from the same inputs."""

from __future__ import annotations

import math

import numpy as np
import torch


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_norm_gap(got: dict, want: dict, masks: dict | None = None) -> tuple[float, str]:
    """The worst leaf's gap between the two sides' norms, over the larger of
    the reference's norm of that leaf and of the median leaf; with
    ``masks``, over the leaves and elements they keep."""
    names = [k for k in want if masks is None or k in masks]

    def part(t, k):
        return t if masks is None else t[masks[k]]

    ng = {k: float(torch.linalg.vector_norm(part(got[k], k).double())) for k in names}
    nw = {k: float(torch.linalg.vector_norm(part(want[k], k).double())) for k in names}
    med = float(np.median([nw[k] for k in names]))
    gaps = {k: abs(ng[k] - nw[k]) / max(nw[k], med, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_elements(grad: dict, leaf_share: float = 1e-3, element_share: float = 1e-5) -> dict:
    """Per leaf, the elements whose reference gradient is not nought to
    rounding. A leaf whose gradient's norm is under ``leaf_share`` of the
    median leaf's is left out whole (a readout's bias that its
    normalisation cancels); in the others, an element under
    ``element_share`` of its leaf's root-mean-square element (float32
    round-off in a sum of such terms: the key's third of a packed QKV bias,
    under the softmax)."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grad.items()}
    med = float(np.median(list(norms.values())))
    out = {}
    for k, g in grad.items():
        if norms[k] < leaf_share * med:
            continue
        out[k] = g.abs() >= element_share * norms[k] / max(g.numel(), 1) ** 0.5
    return out


def entry(name: str, value: float, limit: float) -> dict:
    value = float(value)
    return {"name": name, "value": value if math.isfinite(value) else float("inf"), "limit": float(limit)}


def passed(checks: list) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
