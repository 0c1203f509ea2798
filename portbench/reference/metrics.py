"""The MIND metrics in numpy, float64: per impression AUC (ties share their
average rank), MRR and nDCG@5 and @10 over the candidates in descending
score (among equal scores the later candidate first), then the mean over
impressions (msnews ``evaluate.py``)."""

from __future__ import annotations

import numpy as np


def impression_metrics(scores: np.ndarray, labels: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat ``scores`` and binary ``labels`` of impressions of ``lens``
    candidates -> [impressions, 4] (auc, mrr, ndcg5, ndcg10)."""
    lens = np.asarray(lens, np.int64)
    r, width = len(lens), int(lens.max())
    row = np.repeat(np.arange(r), lens)
    col = np.arange(len(row)) - np.repeat(np.cumsum(lens) - lens, lens)
    s = np.full((r, width), -np.inf)
    y = np.zeros((r, width))
    s[row, col] = np.asarray(scores, np.float64)
    y[row, col] = labels
    asc = np.argsort(s, axis=1, kind="stable")  # padding first, ties by position
    s_asc = np.take_along_axis(s, asc, 1)
    y_asc = np.take_along_axis(y, asc, 1)
    pos = np.arange(1, width + 1, dtype=np.float64)
    n_pos = y.sum(1)
    n_neg = lens - n_pos
    pad = width - lens
    # AUC from average ascending ranks; the padding holds the lowest ranks.
    new_group = np.concatenate([np.ones((r, 1), bool), s_asc[:, 1:] != s_asc[:, :-1]], 1)
    end_group = np.concatenate([s_asc[:, 1:] != s_asc[:, :-1], np.ones((r, 1), bool)], 1)
    first = np.maximum.accumulate(np.where(new_group, pos, 0), axis=1)
    last = np.minimum.accumulate(np.where(end_group, pos, np.inf)[:, ::-1], axis=1)[:, ::-1]
    rank = 0.5 * (first + last) - pad[:, None]
    auc = ((y_asc * rank).sum(1) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    y_desc = y_asc[:, ::-1]
    mrr = (y_desc / pos).sum(1) / n_pos
    gains = y_desc / np.log2(pos + 1)
    disc = 1.0 / np.log2(pos + 1)
    out = [auc, mrr]
    for k in (5, 10):
        ideal = np.array([disc[: min(int(n), k)].sum() for n in n_pos])
        out.append(gains[:, :k].sum(1) / ideal)
    return np.stack(out, 1)


def mind_metrics(scores: np.ndarray, labels: np.ndarray, lens: np.ndarray) -> dict[str, float]:
    m = impression_metrics(scores, labels, lens).mean(0)
    return dict(zip(("auc", "mrr", "ndcg5", "ndcg10"), (float(x) for x in m)))
