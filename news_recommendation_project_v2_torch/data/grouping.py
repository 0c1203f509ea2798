"""Ragged <-> flat segment helpers and per-impression dense ranking
(host-side numpy)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def lengths_to_offsets(lengths: np.ndarray) -> np.ndarray:
    """[n] lengths -> [n+1] exclusive cumsum offsets."""
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def lengths_to_segment_ids(lengths: np.ndarray) -> np.ndarray:
    """[n] lengths -> [sum] int32 segment id per flat slot."""
    return np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)


def truncate_flat_end_aligned(
    flat: np.ndarray, lengths: np.ndarray, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Cap each segment of a flat ragged array at its most recent ``max_len``
    items: returns the new flat array and per-segment lengths. No-op (the
    same array) when nothing exceeds the cap."""
    lengths = np.asarray(lengths)
    if not len(lengths) or not (lengths > max_len).any():
        return np.asarray(flat), lengths
    offsets = lengths_to_offsets(lengths)
    keep = np.minimum(lengths, max_len).astype(np.int64)
    starts = offsets[1:] - keep  # end-aligned: the most recent items
    keep_off = lengths_to_offsets(keep)
    sel = np.repeat(starts, keep) + (np.arange(keep_off[-1]) - np.repeat(keep_off[:-1], keep))
    return np.asarray(flat)[sel], keep


def gather_end_aligned(
    flat: np.ndarray,
    ends: np.ndarray,
    lens: np.ndarray,
    width: int,
    out_rows: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack end-aligned windows of a flat ragged array into a padded block.

    Row ``j`` holds ``flat[ends[j]-min(lens[j],width) : ends[j]]``
    left-justified and zero-padded to ``width`` (the most recent ``width``
    items of each segment), with its float32 mask; ``out_rows`` pads extra
    all-zero rows. Returns int32 indices [out_rows, width] and the mask."""
    n = len(ends)
    out_rows = n if out_rows is None else out_rows
    idx = np.zeros((out_rows, width), np.int32)
    mask = np.zeros((out_rows, width), np.float32)
    if n:
        lens = np.minimum(np.asarray(lens), width)
        starts = np.asarray(ends) - lens
        pos = np.arange(width)
        valid = pos[None, :] < lens[:, None]
        gp = np.minimum(starts[:, None] + pos[None, :], max(len(flat) - 1, 0))
        idx[:n] = np.where(valid, np.asarray(flat)[gp], 0)
        mask[:n] = valid
    return idx, mask


def expand_items(items: np.ndarray, rev_index: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """``items[rev_index]``, where ``counts`` partitions ``rev_index`` into
    segments (checked)."""
    if counts.sum() != len(rev_index):
        raise ValueError("counts must partition rev_index")
    return items[rev_index]


def group_items(items: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Split a flat array into a per-segment object array."""
    offsets = lengths_to_offsets(counts)
    out = np.empty(len(counts), dtype=object)
    for i in range(len(counts)):
        out[i] = items[offsets[i] : offsets[i + 1]]
    return out


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


def rank_group_preds(scores: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-impression dense ranks (``dense_rank_by_segment``) as an object
    array of rank vectors, the form the metric suite takes."""
    return group_items(dense_rank_by_segment(np.asarray(scores), counts), counts)
