"""Per-impression dense ranking over flat segments (host-side numpy)."""

from __future__ import annotations

import numpy as np


def lengths_to_segment_ids(lengths: np.ndarray) -> np.ndarray:
    """[n] lengths -> [sum] int32 segment id per flat slot."""
    return np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)


def dense_rank_by_segment(scores: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Dense descending ranks within each segment, vectorized: per group
    ``scipy.stats.rankdata(-x, method="dense")``. The best score gets rank 1,
    ties share a rank, ranks are consecutive. Returns flat int32 ranks
    aligned with ``scores``."""
    if counts.sum() != len(scores):
        raise ValueError("counts must partition scores")
    seg = lengths_to_segment_ids(counts)
    # Sort by (segment asc, score desc). np.lexsort: last key is primary.
    order = np.lexsort((-scores, seg))
    s_seg = seg[order]
    s_scores = scores[order]
    new_seg = np.empty(len(order), dtype=bool)
    new_seg[0] = True
    new_seg[1:] = s_seg[1:] != s_seg[:-1]
    new_val = np.empty(len(order), dtype=bool)
    new_val[0] = True
    new_val[1:] = s_scores[1:] != s_scores[:-1]
    cum = np.cumsum(new_seg | new_val)
    # Rank within segment = distinct-count since segment start.
    seg_start_cum = np.zeros(len(order), dtype=np.int64)
    start_positions = np.flatnonzero(new_seg)
    seg_start_cum[start_positions] = cum[start_positions]
    seg_start_cum = np.maximum.accumulate(seg_start_cum)
    ranks = np.empty(len(order), dtype=np.int32)
    ranks[order] = (cum - seg_start_cum + 1).astype(np.int32)
    return ranks
