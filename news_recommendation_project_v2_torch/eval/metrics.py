"""The MIND metrics on the host: per-impression AUC / MRR / nDCG@5 / nDCG@10
(numpy only).

The sort is stable, then reversed: among tied scores the later candidate
comes first, which pins the order the msnews ``evaluate.py`` leaves to an
unstable sort; AUC (tie-aware) does not depend on it. The whole evaluation
is one vectorized pass over a padded [num_impressions, max_len] matrix.

Inputs are grouped dense ranks (1 = best), as ``data.grouping`` makes them;
a candidate's metric score is ``1/rank``.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROW_CHUNK = 256  # rows one thread scores at a time
_WORKERS = 4

# ---------------------------------------------------------------------------
# Per-row formulas (cross-checks and tiny inputs).
# ---------------------------------------------------------------------------


def dcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    order = np.argsort(y_score, kind="stable")[::-1]
    y_true = np.take(y_true, order[:k])
    gains = 2**y_true - 1
    discounts = np.log2(np.arange(len(y_true)) + 2)
    return float(np.sum(gains / discounts))


def ndcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    best = dcg_score(y_true, y_true, k)
    actual = dcg_score(y_true, y_score, k)
    return float(actual / best)


def mrr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    order = np.argsort(y_score, kind="stable")[::-1]
    y_true = np.take(y_true, order)
    rr = y_true / (np.arange(len(y_true)) + 1)
    return float(np.sum(rr) / np.sum(y_true))


def auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Tie-aware ROC-AUC by the rank formula; equals scikit-learn's
    ``roc_auc_score`` on binary labels."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = y_true.sum()
    n_neg = len(y_true) - n_pos
    if not (n_pos > 0 and n_neg > 0):
        raise ValueError("AUC undefined without both classes")
    # Average (tie-mid) ascending ranks.
    order = np.argsort(y_score, kind="mergesort")
    s = y_score[order]
    ranks = np.empty(len(s), dtype=np.float64)
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def score_row(
    labels: Sequence[int], sub_ranks: Sequence[int]
) -> tuple[float, float, float, float]:
    """One impression's (auc, mrr, ndcg5, ndcg10) from labels and dense ranks."""
    y_true = np.array(labels, dtype="float32")
    y_score = np.array([1.0 / r for r in sub_ranks])
    if np.any((y_score < 0) | (y_score > 1)):
        raise ValueError("score_rslt should be between 0 and 1")
    return (
        auc_score(y_true, y_score),
        mrr_score(y_true, y_score),
        ndcg_score(y_true, y_score, 5),
        ndcg_score(y_true, y_score, 10),
    )


# ---------------------------------------------------------------------------
# Vectorized batch evaluation.
# ---------------------------------------------------------------------------

_NEG_INF = -np.inf


def _pad_rows(
    rows_ranks: Sequence[Sequence[int]], rows_labels: Sequence[Sequence[int]]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = len(rows_ranks)
    lens = np.array([len(r) for r in rows_ranks], dtype=np.int64)
    max_len = int(lens.max())
    scores = np.full((n, max_len), _NEG_INF, dtype=np.float64)
    labels = np.zeros((n, max_len), dtype=np.float64)
    for i, (r, y) in enumerate(zip(rows_ranks, rows_labels)):
        if len(r) != len(y):
            raise ValueError(f"Row {i}: ranks and labels length mismatch")
        scores[i, : len(r)] = 1.0 / np.asarray(r, dtype=np.float64)
        labels[i, : len(r)] = np.asarray(y, dtype=np.float64)
    return scores, labels, lens


def _score_chunk(
    s: np.ndarray,
    y: np.ndarray,
    ln: np.ndarray,
    a: int,
    out: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
) -> None:
    aucs, mrrs, ndcg5s, ndcg10s = out
    m, L = s.shape
    b = a + m
    npad = L - ln  # padded entries per row (all score -inf)

    # AUC: tie-mid ranks; padding takes the lowest npad ranks.
    # min_rank = #(strictly less) + 1; max_rank = #(<=); avg = (min + max) / 2.
    lt = (s[:, None, :] < s[:, :, None]).sum(-1).astype(np.float64)
    le = (s[:, None, :] <= s[:, :, None]).sum(-1).astype(np.float64)
    avg_ranks = (lt + 1 + le) / 2.0 - npad[:, None]
    n_pos = y.sum(1)
    n_neg = ln - n_pos
    if np.any(n_pos == 0) or np.any(n_neg == 0):
        bad = int(np.flatnonzero((n_pos == 0) | (n_neg == 0))[0]) + a
        raise ValueError(
            f"Impression {bad} has a single label class; AUC is undefined "
            "(scikit-learn's roc_auc_score fails there too)"
        )
    pos_rank_sum = (avg_ranks * y).sum(1)
    aucs[a:b] = (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)

    # Descending score, ties with the larger original index first (the
    # stable sort reversed); -inf padding sorts to the very end.
    idx = np.broadcast_to(np.arange(L, dtype=np.int64), (m, L))
    order = np.lexsort((-idx, -s), axis=-1)
    y_sorted = np.take_along_axis(y, order, axis=-1)

    positions = np.arange(1, L + 1, dtype=np.float64)
    mrrs[a:b] = (y_sorted / positions).sum(1) / np.maximum(n_pos, 1e-12)

    discounts = np.log2(positions + 1.0)
    gains_sorted = (2.0**y_sorted - 1.0) / discounts
    # Ideal ordering: labels descending (0/1 labels: only counts matter).
    y_ideal = np.take_along_axis(y, np.lexsort((-idx, -y), axis=-1), axis=-1)
    ideal_gains = (2.0**y_ideal - 1.0) / discounts
    for k, dest in ((5, ndcg5s), (10, ndcg10s)):
        kk = min(k, L)
        dcg = gains_sorted[:, :kk].sum(1)
        idcg = ideal_gains[:, :kk].sum(1)
        with np.errstate(invalid="ignore", divide="ignore"):
            dest[a:b] = dcg / idcg


def score_batch(
    scores: np.ndarray, labels: np.ndarray, lens: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized (auc, mrr, ndcg5, ndcg10) per row over padded matrices.

    ``scores`` is [N, L] padded with -inf; ``labels`` [N, L] padded with 0;
    ``lens`` [N] real lengths. Chunks of ``_ROW_CHUNK`` rows fan out to
    ``_WORKERS`` threads: the work is numpy, which releases the GIL.
    """
    n = scores.shape[0]
    out = (np.empty(n), np.empty(n), np.empty(n), np.empty(n))

    def run(a: int) -> None:
        b = min(a + _ROW_CHUNK, n)
        _score_chunk(scores[a:b], labels[a:b], lens[a:b], a, out)

    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        list(pool.map(run, range(0, n, _ROW_CHUNK)))  # re-raises a single-class ValueError
    return out


def score(
    preds_input: Sequence[Sequence[int]] | np.ndarray,
    labels_input: Sequence[Sequence[int]] | np.ndarray,
    imp_ids: Sequence[str] = (),
    debug_dir: Optional[Path] = None,
) -> dict[str, float]:
    """Mean MIND metrics over all impressions.

    ``preds_input``: per-impression dense ranks; ``labels_input``: 0/1
    labels. With ``debug_dir`` and ``imp_ids`` the per-impression values are
    written to ``debug_dir/debug_json.json``.
    """
    scores_pad, labels_pad, lens = _pad_rows(preds_input, labels_input)
    live = scores_pad[scores_pad != _NEG_INF]
    if np.any((live < 0) | (live > 1)):
        raise ValueError("1/rank scores must lie in (0, 1]")
    aucs, mrrs, ndcg5s, ndcg10s = score_batch(scores_pad, labels_pad, lens)

    if debug_dir and len(imp_ids) > 0:
        if len(imp_ids) != len(preds_input):
            raise ValueError("Number of impression ids should match the number of preds")
        debug_dir = Path(debug_dir)
        debug_dir.mkdir(parents=True, exist_ok=True)
        with open(debug_dir / "debug_json.json", "w") as f:
            json.dump(
                {
                    "ImpressionID": list(imp_ids),
                    "auc": aucs.tolist(),
                    "mrr": mrrs.tolist(),
                    "ndcg5": ndcg5s.tolist(),
                    "ndcg10": ndcg10s.tolist(),
                    "preds": [list(map(int, p)) for p in preds_input],
                    "labels": [list(map(int, y)) for y in labels_input],
                },
                f,
            )

    return {
        "auc": float(np.mean(aucs)),
        "mrr": float(np.mean(mrrs)),
        "ndcg5": float(np.mean(ndcg5s)),
        "ndcg10": float(np.mean(ndcg10s)),
        "num_samples": len(preds_input),
    }
