"""Analytic batch sizing for serving: batch caps come from arithmetic on the
shapes against the device's memory, not from probing for out-of-memory."""

from __future__ import annotations

from typing import Optional

import torch

# The budget when the device reports none (the CPU): 16 GiB, as in the JAX
# package.
DEFAULT_BUDGET_BYTES = 16 * 1024**3


def _budget(
    hbm_budget_bytes: Optional[int], fraction: float, device: Optional[torch.device]
) -> int:
    if hbm_budget_bytes is None:
        if device is not None and torch.device(device).type == "cuda":
            hbm_budget_bytes = torch.cuda.get_device_properties(device).total_memory
        else:
            hbm_budget_bytes = DEFAULT_BUDGET_BYTES
    return int(hbm_budget_bytes * fraction)


def _floor_pow2(x: int, lo: int = 1024) -> int:
    p = lo
    while p * 2 <= x:
        p *= 2
    return p


def estimate_serve_batch_cap(
    dim: int,
    history_len: int,
    num_candidates: int,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.0625,
    tower_multiplier: int = 12,
    device: Optional[torch.device] = None,
) -> int:
    """Power-of-two request-batch cap for one ``serve.Ranker`` shape group
    ([B, L] histories x [B, C] candidates).

    ``Ranker`` takes a bare tower with no ``TowerConfig``, so the tower's
    internal widths are covered by a generic ``tower_multiplier`` on the
    gathered [L, D] input block (the latent tower's widest activations, the
    8x-dim GEGLU input plus the Q/KV blocks, are ~12x the input row). The
    budget is ``fraction`` of the device's memory (16 GiB on the CPU). Group
    sizes pad up to a power of two below the cap and larger groups chunk at
    it, which bounds pad waste.
    """
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_row = (history_len * dim * tower_multiplier + num_candidates * dim) * 4
    return _floor_pow2(max(budget // max(per_row, 1), 8), lo=8)
