"""The flat eval sharded over the mesh's ranks, with no communication but
its result.

The impression rows are cut into contiguous parts of about equal token
counts, one per rank of the whole mesh (the eval exchanges nothing while it
runs, so the model axis takes rows too). Each rank runs the single-device
``FlatEvalPlan`` body (the gather, the tower with both kernels, the segment
add, the pool, the cosine) over its own rows and their candidate slots,
with the tables and the tower replicated. The latent tower is token-local
and the candidate slots are row-major, so the parts are independent.
``score`` sums the ranks' slot scores, each rank's zeros elsewhere, with one
``all_reduce`` (exact: only zeros are added); ``metrics``, with a
``ShardedMetricsPlan``, composes and scores each rank's impressions where
they are and sums five scalars.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..data.grouping import lengths_to_offsets, truncate_flat_end_aligned
from ..device import resolve_device
from ..eval.device_metrics import DeviceMetricsPlan, metric_sums
from ..ops.scoring import COSINE_CHUNK, DEFAULT_FLAT_CHUNK, FlatEvalPlan
from .mesh import Mesh


def partition_rows_by_tokens(hist_lens: np.ndarray, parts: int) -> np.ndarray:
    """[parts+1] contiguous row boundaries with ~equal token counts per part:
    each split point is the row boundary whose token cumsum is NEAREST the
    ideal target (at-or-after alone degenerates on skewed lengths — a single
    long row at a boundary would hand one device everything)."""
    offsets = lengths_to_offsets(hist_lens)
    total = int(offsets[-1])
    targets = (np.arange(1, parts) * total) // parts
    hi = np.searchsorted(offsets, targets, side="left")  # first offset >= target
    lo = np.maximum(hi - 1, 0)
    cuts = np.where(
        np.abs(offsets[np.minimum(hi, len(offsets) - 1)] - targets)
        < np.abs(targets - offsets[lo]),
        np.minimum(hi, len(offsets) - 1),
        lo,
    )
    bounds = np.concatenate([[0], cuts, [len(hist_lens)]])
    return np.maximum.accumulate(bounds)  # monotone even for degenerate splits


class ShardedFlatEvalPlan:
    """``FlatEvalPlan`` over the mesh: build once per (dataset, mesh) on
    every rank, score many times. Candidate slots may come in any order:
    they are grouped by row (stably) and the order restored in ``score``.
    ``token_share`` is this rank's share of the history tokens.
    ``device=None`` means CUDA."""

    def __init__(
        self,
        mesh: Mesh,
        hist_rev: np.ndarray,
        hist_lens: np.ndarray,
        cand_rev: np.ndarray,
        cand_row: np.ndarray,
        chunk_tokens: int = DEFAULT_FLAT_CHUNK,
        cand_chunk: int = COSINE_CHUNK,
        max_len: Optional[int] = None,
        device=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(device)
        hist_rev = np.asarray(hist_rev, np.int64)
        hist_lens = np.asarray(hist_lens)
        cand_rev = np.asarray(cand_rev, np.int64)
        cand_row = np.asarray(cand_row, np.int64)
        if max_len is not None:
            hist_rev, hist_lens = truncate_flat_end_aligned(hist_rev, hist_lens, max_len)
        order = np.argsort(cand_row, kind="stable")
        self._order = order
        self._unsort = np.empty_like(order)
        self._unsort[order] = np.arange(len(order))
        cand_rev, cand_row = cand_rev[order], cand_row[order]

        bounds = partition_rows_by_tokens(hist_lens, mesh.size)
        offsets = lengths_to_offsets(hist_lens)
        cand_bounds = np.searchsorted(cand_row, bounds, side="left")
        self.num_slots = len(cand_rev)
        self._bounds, self._cand_bounds = bounds, cand_bounds
        r0, r1 = bounds[mesh.rank], bounds[mesh.rank + 1]
        c0, c1 = cand_bounds[mesh.rank], cand_bounds[mesh.rank + 1]
        self._slots = slice(int(c0), int(c1))
        self.token_share = float(offsets[r1] - offsets[r0]) / max(int(offsets[-1]), 1)
        self.local = None
        if r1 > r0:
            self.local = FlatEvalPlan(
                hist_rev[offsets[r0] : offsets[r1]], hist_lens[r0:r1], cand_rev[c0:c1], cand_row[c0:c1] - r0,
                chunk_tokens=chunk_tokens, cand_chunk=cand_chunk, device=self.device,
            )

    def _local_scores(self, tower, news_emb, query_news_emb, normalize) -> torch.Tensor:
        """This rank's slot scores, in row order, on the device."""
        if self.local is None:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        return self.local._scores(tower, news_emb, query_news_emb, normalize)

    @torch.inference_mode()
    def score(self, tower: torch.nn.Module, news_emb, query_news_emb=None, normalize: Optional[bool] = None) -> np.ndarray:
        """[num_slots] float32 cosine scores in the caller's slot order, on
        every rank (``FlatEvalPlan.score``'s arguments)."""
        full = torch.zeros(self.num_slots, dtype=torch.float32, device=self.device)
        full[self._slots] = self._local_scores(tower, news_emb, query_news_emb, normalize)
        return self.mesh.sum(full).cpu().numpy()[self._unsort]

    @torch.inference_mode()
    def metrics(
        self,
        tower: torch.nn.Module,
        news_emb,
        metrics_plan: "ShardedMetricsPlan",
        query_news_emb=None,
        normalize: Optional[bool] = None,
        alpha: Union[None, float, torch.Tensor] = None,
    ) -> dict[str, float]:
        """The whole eval, sharded: each rank scores, composes and measures
        its own impressions; the five metric sums are added over the mesh
        and every rank returns the same dict, equal to
        ``FlatEvalPlan.metrics``'s."""
        sums = metrics_plan.local_sums(self._local_scores(tower, news_emb, query_news_emb, normalize), alpha)
        return DeviceMetricsPlan.finalize(self.mesh.sum(sums).tolist())


class ShardedMetricsPlan:
    """The companion of ``ShardedFlatEvalPlan``: each rank holds a
    ``DeviceMetricsPlan`` of the impressions whose history row it scores
    (the eval plan's row parts), so it composes and measures them where
    their scores are. Impressions without history (baseline scores only)
    are dealt round-robin.

    ``imp_rows`` maps each impression to its with-history row (-1: none),
    the row space of ``eval.ranker.history_candidate_slots``; ``None`` is
    ``arange`` (a with-history view, the trainers' layout). The other
    arguments are ``DeviceMetricsPlan``'s. Single-class impressions raise
    ``ValueError`` on every rank."""

    def __init__(
        self,
        eval_plan: ShardedFlatEvalPlan,
        imp_lens: np.ndarray,
        labels_flat: np.ndarray,
        hist_slots: Optional[np.ndarray] = None,
        imp_rows: Optional[np.ndarray] = None,
        baseline_slots: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
        row_chunk: Optional[int] = None,
    ):
        imp_lens = np.asarray(imp_lens, dtype=np.int64)
        if imp_lens.min() < 1:
            raise ValueError("every impression needs at least one candidate")
        labels_flat = np.asarray(labels_flat, dtype=np.float32)
        total_slots = int(imp_lens.sum())
        if len(labels_flat) != total_slots:
            raise ValueError(f"{len(labels_flat)} labels for {total_slots} slots")
        offsets = lengths_to_offsets(imp_lens)
        pos_per_imp = np.add.reduceat(labels_flat, offsets[:-1])
        single = (pos_per_imp == 0) | (pos_per_imp == imp_lens)
        if single.any():
            raise ValueError(
                f"{int(single.sum())} impression(s) have a single label class; "
                "AUC is undefined (scikit-learn's roc_auc_score fails there too)"
            )
        base = np.zeros(total_slots, np.float32) if baseline_slots is None else np.asarray(baseline_slots, np.float32)
        if len(base) != total_slots:
            raise ValueError(f"{len(base)} baseline scores for {total_slots} slots")
        num_imps = len(imp_lens)
        imp_rows = np.arange(num_imps, dtype=np.int64) if imp_rows is None else np.asarray(imp_rows, np.int64)

        mesh, bounds = eval_plan.mesh, eval_plan._bounds
        owner = np.empty(num_imps, dtype=np.int64)
        owned = imp_rows >= 0
        owner[owned] = np.minimum(np.searchsorted(bounds, imp_rows[owned], side="right") - 1, mesh.size - 1)
        owner[~owned] = np.arange(int((~owned).sum())) % mesh.size

        self.device = eval_plan.device
        self.alpha = None if alpha is None else float(alpha)
        imps = np.flatnonzero(owner == mesh.rank)
        self.num_impressions = len(imps)
        self.local = None
        if not len(imps):
            return
        lens = imp_lens[imps]
        local_off = lengths_to_offsets(lens)
        # Local slot -> global slot, row-major within each impression.
        g = np.repeat(offsets[imps] - local_off[:-1], lens) + np.arange(int(local_off[-1]))
        local_hist = None
        if hist_slots is not None:
            # This rank's cosine scores (its slots, in row order) land at
            # these local composed positions.
            gpos = np.asarray(hist_slots, np.int64)[eval_plan._order[eval_plan._slots]]
            imp = np.searchsorted(offsets, gpos, side="right") - 1
            k = np.searchsorted(imps, imp)
            if not (imps[np.minimum(k, len(imps) - 1)] == imp).all():
                raise ValueError("a history slot's impression is not owned by the rank of its row")
            local_hist = local_off[k] + (gpos - offsets[imp])
        self.local = DeviceMetricsPlan(
            lens, labels_flat[g], hist_slots=local_hist, baseline_slots=base[g], alpha=alpha,
            row_chunk=row_chunk, device=self.device,
        )

    def local_sums(self, hist_scores: torch.Tensor, alpha: Union[None, float, torch.Tensor] = None) -> torch.Tensor:
        """[5] metric sums of this rank's impressions (zeros where it owns
        none) from its history slots' scores."""
        if self.local is None:
            return torch.zeros(5, dtype=torch.float32, device=self.device)
        scores = hist_scores if self.local.hist_slots is not None else None
        return metric_sums(self.local.compose(scores, alpha), self.local.grids)
