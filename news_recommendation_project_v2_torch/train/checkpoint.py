"""Checkpointing: per-epoch and metric-gated best checkpoints, written with
``torch.save``.

``Epoch_{i}`` every epoch and ``Best_model_{exp}`` gated on the mean of
(auc, mrr, ndcg5, ndcg10) on the dev split, as in the JAX package (which
writes them with Orbax).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def save_pytree(path: Path, tree: Any) -> None:
    """``torch.save`` of ``tree`` (tensors, numbers, strings and containers of
    them) into a temporary file renamed onto ``path``: a reader never sees a
    half-written checkpoint."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_pytree(path: Path) -> Any:
    """What ``save_pytree`` wrote, with every tensor on the CPU. Only
    tensors, numbers, strings and containers load (``weights_only``): a
    checkpoint runs no code."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def mean_metric(scores: dict[str, float]) -> float:
    """Model-selection criterion: mean of (auc, mrr, ndcg5, ndcg10)."""
    return float(np.mean([scores["auc"], scores["mrr"], scores["ndcg5"], scores["ndcg10"]]))


class BestTracker:
    """Saves every epoch's checkpoint and keeps the best by ``mean_metric``
    (nothing when ``ckpt_dir`` is None)."""

    def __init__(self, ckpt_dir: Optional[Path], exp_name: str):
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.exp_name = exp_name
        self.best_score = -np.inf
        self.best_path: Optional[Path] = None

    def update(self, epoch: int, scores: dict[str, float], tree: Any) -> bool:
        if self.ckpt_dir is None:
            return False
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        save_pytree(self.ckpt_dir / f"Epoch_{epoch}", tree)
        m = mean_metric(scores)
        if m > self.best_score:
            self.best_score = m
            self.best_path = self.ckpt_dir / f"Best_model_{self.exp_name}"
            save_pytree(self.best_path, tree)
            return True
        return False
