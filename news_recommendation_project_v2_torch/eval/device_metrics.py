"""The MIND metrics on the device: AUC / MRR / nDCG@5 / nDCG@10 computed where
the scores are, so a whole evaluation fetches five scalars instead of the
per-slot score vector.

The values are the host pipeline's (``eval.metrics.score_batch`` over
``1/dense_rank``): dense ranking is strictly monotonic and keeps ties within
an impression, and AUC, MRR and nDCG depend only on that order and its ties,
so they are computed from the composed scores directly.

Tie order is the host's: descending score, ties with the larger original
index first. One ascending stable ``torch.sort`` orders by (score, index);
read backwards it is that order, and ``-inf`` padding sorts to the front.
AUC is tie-aware (average ranks over sorted tie groups), O(L log L) a row.

``DeviceMetricsPlan`` is the per-dataset companion of
``ops.scoring.FlatEvalPlan``: impression-length-bucketed index grids built
and uploaded once, plus the constants of ``eval.ranker.compose_final_scores``
(baseline scores, history slot positions, alpha). What depends only on the
labels (positive counts, ideal DCG, the single-class check) is computed on
the host at build, so the device sorts only live scores.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..data.grouping import lengths_to_offsets
from ..device import resolve_device

__all__ = ["row_metrics", "DeviceMetricsPlan", "metrics_from_flat_scores"]


class MetricGrid(NamedTuple):
    """One impression-length bucket, in chunks of rows."""

    idx: torch.Tensor  # [n_chunks, chunk, L] int64 into the scores (fill = C)
    labels: torch.Tensor  # [n_chunks, chunk, L] float32 binary
    lens: torch.Tensor  # [n_chunks, chunk] float32 (0 = padded row)
    n_pos: torch.Tensor  # [n_chunks, chunk] float32 positives per row
    idcg5: torch.Tensor  # [n_chunks, chunk] float32 ideal DCG@5
    idcg10: torch.Tensor  # [n_chunks, chunk] float32 ideal DCG@10


def _row_metrics_core(
    scores: torch.Tensor,  # [m, L] float32, padding = -inf
    labels: torch.Tensor,  # [m, L] float32 binary, padding = 0
    lens: torch.Tensor,  # [m] float32 real candidate counts (0 = padded row)
    n_pos: torch.Tensor,  # [m] float32
    idcg5: torch.Tensor,  # [m] float32
    idcg10: torch.Tensor,  # [m] float32
) -> tuple[torch.Tensor, ...]:
    """Per-impression (auc, mrr, ndcg5, ndcg10) from the label-derived
    values. One sort; O(L log L) a row."""
    m, L = scores.shape
    # Ascending by (score, index); read backwards, descending score with
    # the larger index first among ties.
    s_asc, perm = torch.sort(scores, dim=-1, stable=True)
    y_asc = labels.gather(-1, perm)
    pos = torch.arange(1, L + 1, dtype=torch.float32, device=scores.device)

    # AUC: a tie group on ascending positions [a, b] has the average rank
    # (a + b) / 2.
    neq = s_asc[:, 1:] != s_asc[:, :-1]
    edge = torch.ones((m, 1), dtype=torch.bool, device=scores.device)
    group_first = torch.cat([edge, neq], dim=1)
    group_last = torch.cat([neq, edge], dim=1)
    zero = torch.zeros((), device=scores.device)
    inf = torch.full((), torch.inf, device=scores.device)
    start = torch.cummax(torch.where(group_first, pos, zero), dim=1).values
    end = torch.cummin(torch.where(group_last, pos, inf).flip(1), dim=1).values.flip(1)
    avg_rank = 0.5 * (start + end)
    n_neg = lens - n_pos
    npad = L - lens
    # Padding takes the lowest npad ascending ranks; real ranks shift down.
    pos_rank_sum = (y_asc * avg_rank).sum(dim=1) - n_pos * npad
    auc = (pos_rank_sum - n_pos * (n_pos + 1) * 0.5) / (n_pos * n_neg).clamp_min(1e-12)

    # MRR and nDCG from the descending order.
    y_desc = y_asc.flip(1)
    mrr = (y_desc / pos).sum(dim=1) / n_pos.clamp_min(1e-12)
    # gains = (2**y - 1) / log2(pos + 1); binary labels make 2**y - 1 == y.
    gains = y_desc * (1.0 / torch.log2(pos + 1.0))
    ndcg5 = gains[:, :5].sum(dim=1) / idcg5.clamp_min(1e-12)
    ndcg10 = gains[:, :10].sum(dim=1) / idcg10.clamp_min(1e-12)
    return auc, mrr, ndcg5, ndcg10


def _ideal_dcg(labels: torch.Tensor, k: int) -> torch.Tensor:
    """Ideal DCG@k of binary labels: the first min(n_pos, k) discounts."""
    pos = torch.arange(1, labels.shape[-1] + 1, dtype=torch.float32, device=labels.device)
    disc = 1.0 / torch.log2(pos + 1.0)
    n_pos = labels.sum(dim=-1, keepdim=True)
    take = (pos <= torch.clamp(n_pos, max=float(k))) & (pos <= k)
    return (take * disc).sum(dim=-1)


def row_metrics(
    scores: torch.Tensor, labels: torch.Tensor, lens: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Per-impression (auc, mrr, ndcg5, ndcg10, bad), the label-derived
    values computed here. ``bad`` flags real rows with a single label class
    (the host path raises there); their metric values must not be used."""
    n_pos = labels.sum(dim=1)
    auc, mrr, n5, n10 = _row_metrics_core(
        scores, labels, lens, n_pos, _ideal_dcg(labels, 5), _ideal_dcg(labels, 10)
    )
    bad = (lens > 0) & ((n_pos == 0) | (n_pos == lens))
    return auc, mrr, n5, n10, bad


def compose_scores(
    baseline: torch.Tensor,
    hist_slots: Optional[torch.Tensor],
    hist_scores: Optional[torch.Tensor],
    alpha: Union[None, float, torch.Tensor] = None,
) -> torch.Tensor:
    """Full-slot composed scores from the history slots' cosine scores, in
    float32 (``compose_final_scores``'s assembly). Out of place: ``baseline``
    is left as it is. ``alpha`` may be a tensor, a trained blend weight."""
    full = baseline
    if hist_scores is not None:
        if hist_slots is None:
            raise ValueError("history scores need the plan's history slots")
        hist_scores = hist_scores.to(full.dtype)
        if alpha is not None:
            hist_scores = alpha * hist_scores + (1.0 - alpha) * full[hist_slots]
        full = full.index_put((hist_slots,), hist_scores)
    return full


def metric_sums(full_scores: torch.Tensor, grids: tuple[MetricGrid, ...]) -> torch.Tensor:
    """[5] float32 (auc, mrr, ndcg5, ndcg10, count) sums over every
    impression of the [total_slots] composed scores, chunk by chunk in grid
    order; on the device, without a host sync."""
    scores_ext = torch.cat([full_scores, full_scores.new_full((1,), -torch.inf)])
    total = torch.zeros(5, dtype=torch.float32, device=full_scores.device)
    for g in grids:
        for c in range(g.idx.shape[0]):
            metrics = _row_metrics_core(
                scores_ext[g.idx[c]], g.labels[c], g.lens[c], g.n_pos[c], g.idcg5[c], g.idcg10[c]
            )
            valid = (g.lens[c] > 0).float()
            total = total + torch.stack([(v * valid).sum() for v in metrics] + [valid.sum()])
    return total


def _metric_buckets(max_len: int) -> tuple[int, ...]:
    """Power-of-two length buckets, the last one the dataset's exact
    maximum: each impression pads to its bucket (at most 2x its slots), not
    to the global maximum."""
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class DeviceMetricsPlan:
    """Per-dataset metric grids and score-composition constants on one
    device.

    Mirrors ``eval.ranker.compose_final_scores``: the final slot scores
    start from ``baseline_slots`` (zeros when absent), the history slots are
    overwritten with (or alpha-blended against) the tower's cosine scores,
    and every impression is scored with the MIND metric suite. The
    dense-rank step is left out: see the module docstring for why that is
    exact. Single-class impressions raise ``ValueError`` here, at build.
    ``device=None`` means CUDA (``device.resolve_device``).
    """

    def __init__(
        self,
        imp_lens: np.ndarray,
        labels_flat: np.ndarray,
        hist_slots: Optional[np.ndarray] = None,
        baseline_slots: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
        row_chunk: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        imp_lens = np.asarray(imp_lens, dtype=np.int64)
        if imp_lens.min() < 1:
            raise ValueError("every impression needs at least one candidate")
        labels_flat = np.asarray(labels_flat, dtype=np.float32)
        total_slots = int(imp_lens.sum())
        if len(labels_flat) != total_slots:
            raise ValueError(f"{len(labels_flat)} labels for {total_slots} slots")
        self.num_impressions = len(imp_lens)
        self.alpha = None if alpha is None else float(alpha)
        self.hist_slots = (
            None if hist_slots is None else self._upload(np.asarray(hist_slots, np.int64))
        )
        base = (
            np.zeros(total_slots, np.float32)
            if baseline_slots is None
            else np.asarray(baseline_slots, dtype=np.float32)
        )
        if len(base) != total_slots:
            raise ValueError(f"{len(base)} baseline scores for {total_slots} slots")
        self.baseline = self._upload(base)

        offsets = lengths_to_offsets(imp_lens)
        # Label-derived values, once on the host.
        pos_per_imp = np.add.reduceat(labels_flat, offsets[:-1]).astype(np.float32)
        single = (pos_per_imp == 0) | (pos_per_imp == imp_lens)
        if single.any():
            raise ValueError(
                f"{int(single.sum())} impression(s) have a single label class; "
                "AUC is undefined (scikit-learn's roc_auc_score fails there too)"
            )

        if row_chunk is None:
            from ..utils.memory import estimate_metric_rows

            row_chunk = estimate_metric_rows(int(imp_lens.max()), device=self.device)
        bucket_arr = np.asarray(_metric_buckets(int(imp_lens.max())))
        bucket_ids = np.searchsorted(bucket_arr, imp_lens)
        grids = []
        for bid in np.unique(bucket_ids):
            L = int(bucket_arr[bid])
            rows = np.flatnonzero(bucket_ids == bid)
            chunk = max(min(row_chunk, 1 << int(np.ceil(np.log2(len(rows))))), 1)
            n_pad = -(-len(rows) // chunk) * chunk
            pad = n_pad - len(rows)
            lens_b = imp_lens[rows]
            # Row i covers slots [offsets[r], +len_r); the fill total_slots
            # points at the -inf slot metric_sums appends.
            span = np.arange(L)
            idx = offsets[rows][:, None] + span[None, :]
            mask = span[None, :] < lens_b[:, None]
            idx = np.where(mask, np.minimum(idx, total_slots - 1), total_slots)
            ygrid = np.where(mask, labels_flat[np.minimum(idx, total_slots - 1)], 0.0)
            npos_b = pos_per_imp[rows]
            # Ideal DCG@k of binary labels: the first min(n_pos, k) discounts.
            disc = 1.0 / np.log2(np.arange(1, L + 1, dtype=np.float64) + 1.0)
            cumdisc = np.concatenate([[0.0], np.cumsum(disc)])
            idcg5 = cumdisc[np.minimum(npos_b, 5).astype(np.int64)]
            idcg10 = cumdisc[np.minimum(npos_b, 10).astype(np.int64)]

            def padded(a, dtype, fill=0):
                a = np.concatenate([a.astype(dtype), np.full((pad,) + a.shape[1:], fill, dtype)])
                return self._upload(a.reshape((n_pad // chunk, chunk) + a.shape[1:]))

            grids.append(
                MetricGrid(
                    idx=padded(idx, np.int64, total_slots),
                    labels=padded(ygrid, np.float32),
                    lens=padded(lens_b, np.float32),
                    n_pos=padded(npos_b, np.float32),
                    idcg5=padded(idcg5, np.float32),
                    idcg10=padded(idcg10, np.float32),
                )
            )
        self.grids = tuple(grids)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def compose(
        self, hist_scores: Optional[torch.Tensor], alpha: Union[None, float, torch.Tensor] = None
    ) -> torch.Tensor:
        """Composition with this plan's constants (``compose_scores``);
        ``alpha`` overrides the plan's. A numeric alpha becomes a float32
        scalar on the device by a fill, not a copy from the host: no sync."""
        alpha = self.alpha if alpha is None else alpha
        if isinstance(alpha, torch.Tensor):
            alpha = alpha.to(self.device, torch.float32)
        elif alpha is not None:
            alpha = torch.full((), float(alpha), dtype=torch.float32, device=self.device)
        return compose_scores(self.baseline, self.hist_slots, hist_scores, alpha=alpha)

    @staticmethod
    def finalize(sums) -> dict[str, float]:
        """Metric means from the five fetched sums."""
        auc_s, mrr_s, n5_s, n10_s, count = (float(x) for x in sums)
        return {
            "auc": auc_s / count,
            "mrr": mrr_s / count,
            "ndcg5": n5_s / count,
            "ndcg10": n10_s / count,
            "num_samples": int(count),
        }

    @torch.inference_mode()
    def compute(self, full_scores) -> dict[str, float]:
        """Composed full-slot scores (numpy or a tensor) -> the metric dict,
        with one host sync."""
        scores = torch.as_tensor(full_scores, dtype=torch.float32, device=self.device)
        return self.finalize(metric_sums(scores, self.grids).tolist())


def metrics_from_flat_scores(
    full_scores: np.ndarray,
    imp_lens: np.ndarray,
    labels_flat: np.ndarray,
    row_chunk: Optional[int] = None,
    device=None,
) -> dict[str, float]:
    """The device metric dict of an already-composed flat score vector."""
    plan = DeviceMetricsPlan(imp_lens, labels_flat, row_chunk=row_chunk, device=device)
    return plan.compute(full_scores)
