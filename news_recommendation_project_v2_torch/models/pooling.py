"""Sequence pooling."""

from __future__ import annotations

import torch


def average_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the history axis: [B, L, D], [B, L] -> [B, D]. The
    Ranker's scorer when no tower checkpoint is given."""
    m = mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
