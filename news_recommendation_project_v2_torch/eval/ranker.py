"""Score composition, ranking and the host metrics for a compiled behaviors
set: start from a content-only baseline for every candidate slot, overwrite
the slots of with-history rows with the tower's cosine scores (or blend them
with the baseline by ``alpha``), dense-rank per impression and run the MIND
metric suite."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..data.compiler import CompiledBehaviors
from ..data.grouping import dense_rank_by_segment, group_items
from .metrics import score


@dataclasses.dataclass
class ScoreResult:
    scores: np.ndarray  # [total_imp_slots] flat final scores
    grouped_ranks: np.ndarray  # object array of per-impression dense ranks
    metrics: Optional[dict] = None


def history_candidate_slots(c: CompiledBehaviors) -> tuple[np.ndarray, np.ndarray]:
    """The flat candidate slots of with-history rows, and each slot's row in
    the with-history subset."""
    has_hist = c.has_history
    slot_mask = np.repeat(has_hist, c.imp_lens)
    subset_pos = np.cumsum(has_hist) - 1  # original row -> with-history row
    cand_rows = subset_pos[c.imp_row[slot_mask]].astype(np.int32)
    return np.flatnonzero(slot_mask), cand_rows


def compose_final_scores(
    c: CompiledBehaviors,
    history_scores: Optional[np.ndarray] = None,
    baseline_scores: Optional[np.ndarray] = None,
    alpha: Optional[float] = None,
    compute_metrics: bool = True,
) -> ScoreResult:
    """Final per-slot scores, in float64.

    - ``baseline_scores``: per-unique-news content scores, expanded to slots
      through ``imp_rev``; zeros when absent.
    - ``history_scores``: cosine scores of the with-history candidate slots,
      in ``history_candidate_slots`` order.
    - ``alpha``: if given, ``alpha*cos + (1-alpha)*baseline`` on those slots.
    """
    scores = (
        baseline_scores[c.imp_rev].astype(np.float64)
        if baseline_scores is not None
        else np.zeros(len(c.imp_rev), dtype=np.float64)
    )
    if history_scores is not None:
        slots, _ = history_candidate_slots(c)
        if len(slots) != len(history_scores):
            raise ValueError(
                f"{len(history_scores)} history scores for {len(slots)} history slots"
            )
        if alpha is not None:
            scores[slots] = alpha * history_scores + (1 - alpha) * scores[slots]
        else:
            scores[slots] = history_scores
    ranks_flat = dense_rank_by_segment(scores, c.imp_lens)
    grouped_ranks = group_items(ranks_flat, c.imp_lens)
    m = None
    if compute_metrics:
        if c.labels_flat is None:
            raise ValueError("Metrics need labels")
        labels = group_items(c.labels_flat, c.imp_lens)
        m = score([g.tolist() for g in grouped_ranks], [g.tolist() for g in labels])
    return ScoreResult(scores=scores, grouped_ranks=grouped_ranks, metrics=m)
