"""Request-level serving API: rank candidate news for a user's clicked history.

A trained tower and an embedding table become a ranker: id lookup on the
host, one tower call per request (history lengths bucketed, as in the JAX
package, so the kernels see a small fixed set of shapes), cosine scoring on
the device, ranked ids back. One device; multi-GPU serving comes last
(ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .config import HISTORY_BUCKETS, IMPRESSION_BUCKETS, bucket_for
from .data.grouping import dense_rank_by_segment
from .device import resolve_device
from .utils.inflight import InflightWindow
from .utils.memory import estimate_serve_batch_cap

EPS = 1e-8  # cosine norm clamp

Tower = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # ([B,L,D], [B,L]) -> [B,D]


class Ranker:
    """Serve ranked candidates for one user request.

    ``tower`` maps gathered history embeddings [B, L, D] and their mask
    [B, L] to user vectors [B, D]; an ``nn.Module`` tower is moved to the
    ranker's device. ``news_ids`` aligns the embedding table rows with
    external news ids (the same id-keyed contract as the embedding dumps).
    Unknown history ids are dropped; unknown candidate ids score ``-inf`` and
    rank last; ties keep candidate order.
    """

    def __init__(
        self,
        tower: Tower,
        news_emb,  # [N, D] numpy array or tensor
        news_ids: Sequence[str],
        query_news_emb=None,
        buckets: tuple[int, ...] = HISTORY_BUCKETS,
        candidate_buckets: tuple[int, ...] = IMPRESSION_BUCKETS,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported: multi-GPU is the last item of "
                "ROADMAP.md §1; the port serves from one device"
            )
        self.device = resolve_device(device)
        if isinstance(tower, nn.Module):
            tower = tower.to(self.device).eval()
        self.tower = tower
        self.news_emb = torch.as_tensor(news_emb, device=self.device)
        self.query_emb = (
            self.news_emb
            if query_news_emb is None
            else torch.as_tensor(query_news_emb, device=self.device)
        )
        self.num_news = int(self.news_emb.shape[0])
        self._news_norm = torch.linalg.norm(self.news_emb, dim=-1).clamp_min(EPS)
        self.row_of = {str(n): i for i, n in enumerate(news_ids)}
        self.id_of = [str(n) for n in news_ids]
        self.buckets = buckets
        self.candidate_buckets = candidate_buckets
        self._cap_cache: dict[tuple[int, int], int] = {}

    # -- device side ---------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # Pinned and non-blocking, so a copy does not wait for the
            # device's queue to drain (rank_batch keeps several calls queued).
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def _users(self, hist_idx: np.ndarray, hist_mask: np.ndarray) -> torch.Tensor:
        """[B, L] history rows and mask -> [B, D] user vectors."""
        idx, mask = self._to_device(hist_idx), self._to_device(hist_mask)
        gathered = self.query_emb[idx] * mask[..., None].to(self.query_emb.dtype)
        return self.tower(gathered, mask)

    @torch.inference_mode()
    def _cosine(self, user: torch.Tensor, cand_idx: np.ndarray) -> torch.Tensor:
        """[B, D] users x [B, C] candidate rows -> [B, C] cosine scores."""
        idx = self._to_device(cand_idx)
        nu = torch.linalg.norm(user, dim=-1).clamp_min(EPS)[:, None]
        dots = torch.einsum("bcd,bd->bc", self.news_emb[idx], user)
        return dots / (nu * self._news_norm[idx])

    # -- host side -----------------------------------------------------------

    def _history(self, history_ids: Sequence[str], what: str) -> tuple[list[int], int]:
        """Known history rows, most recent ``L`` kept, and the bucket ``L``."""
        hist = [self.row_of[h] for h in history_ids if h in self.row_of]
        if not hist:
            raise ValueError(f"{what}: no known history ids; cold-start requests "
                             "need the classification baseline, not the tower ranker")
        L = bucket_for(len(hist), self.buckets)
        return hist[-L:], L

    @staticmethod
    def _history_grid(hists: Sequence[list[int]], L: int, B: int):
        """[B, L] row and mask grids; rows past ``len(hists)`` are pad rows
        with one live token, so the tower stays finite on them."""
        hist_idx = np.zeros((B, L), np.int64)
        hist_mask = np.zeros((B, L), np.float32)
        hist_mask[len(hists):, 0] = 1.0
        for j, hist in enumerate(hists):
            hist_idx[j, : len(hist)] = hist
            hist_mask[j, : len(hist)] = 1.0
        return hist_idx, hist_mask

    def _batch_cap(self, L: int, C: int) -> int:
        """Per-shape-group request-batch cap for ``rank_batch``, from the
        analytic memory model (``utils/memory.py``)."""
        key = (L, C)
        if key not in self._cap_cache:
            self._cap_cache[key] = estimate_serve_batch_cap(
                int(self.news_emb.shape[1]), L, C, device=self.device
            )
        return self._cap_cache[key]

    def _chunk_sizes(self, n: int) -> list[int]:
        """Candidate-axis padded shapes for an ``n``-candidate request: one
        bucket when it fits, else ceil(n / max_bucket) chunks of the largest
        bucket, so every candidate shape is drawn from ``candidate_buckets``."""
        max_c = self.candidate_buckets[-1]
        if n <= max_c:
            return [bucket_for(max(n, 1), self.candidate_buckets)]
        return [max_c] * (-(-n // max_c))

    def rank(
        self, history_ids: Sequence[str], candidate_ids: Sequence[str]
    ) -> list[tuple[str, float]]:
        """Returns candidates sorted best-first with their cosine scores."""
        hist, L = self._history(history_ids, "rank")
        known = [self.row_of.get(c, -1) for c in candidate_ids]
        user = self._users(*self._history_grid([hist], L, 1))
        # The user vector is candidate-free, so chunks of the candidate axis
        # score independently. Every chunk is queued before any is fetched.
        pending = []
        start = 0
        for C in self._chunk_sizes(len(known)):
            part = known[start : start + C]
            cand_idx = np.zeros((1, C), np.int64)
            cand_idx[0, : len(part)] = np.maximum(part, 0)
            pending.append((self._cosine(user, cand_idx)[0], len(part)))
            start += C
        scores = np.concatenate([s.cpu().numpy()[:n] for s, n in pending])
        scores = np.where(np.asarray(known) >= 0, scores, -np.inf)
        order = np.argsort(-scores, kind="stable")
        return [(candidate_ids[i], float(scores[i])) for i in order]

    @torch.inference_mode()
    def retrieve(
        self, history_ids: Sequence[str], k: int = 10
    ) -> list[tuple[str, float]]:
        """Exhaustive top-k over the whole news table: one product over
        [N, D] and a stable descending sort on the device."""
        hist, L = self._history(history_ids, "retrieve")
        user = self._users(*self._history_grid([hist], L, 1))[0]
        nu = torch.linalg.norm(user).clamp_min(EPS)
        scores = (self.news_emb @ user) / (nu * self._news_norm)
        kk = min(k, self.num_news)
        top, idx = torch.sort(scores, descending=True, stable=True)
        top, idx = top[:kk].cpu().numpy(), idx[:kk].cpu().numpy()
        return [(self.id_of[i], float(s)) for i, s in zip(idx, top)]

    def rank_batch(
        self,
        requests: Sequence[tuple[Sequence[str], Sequence[str]]],
    ) -> list[list[tuple[str, float]]]:
        """Throughput path: many (history_ids, candidate_ids) requests scored
        in one tower call per (history-bucket, candidate-bucket) shape group.
        Oversized candidate lists expand into sub-rows over the largest
        bucket; their scores merge after."""
        prepared = []  # (req_i, chunk_start, hist, known_chunk, L, C)
        for req_i, (history_ids, candidate_ids) in enumerate(requests):
            hist, L = self._history(history_ids, f"request {req_i}")
            known = [self.row_of.get(c, -1) for c in candidate_ids]
            start = 0
            for C in self._chunk_sizes(len(known)):
                prepared.append((req_i, start, hist, known[start : start + C], L, C))
                start += C

        merged: list[dict[int, np.ndarray]] = [dict() for _ in requests]
        by_shape: dict[tuple[int, int], list] = {}
        for item in prepared:
            by_shape.setdefault((item[4], item[5]), []).append(item)

        def consume(item) -> None:
            dev, chunk = item
            scores = dev.cpu().numpy()
            for j, (req_i, start, _, known, _, _) in enumerate(chunk):
                merged[req_i][start] = np.where(
                    np.asarray(known) >= 0, scores[j, : len(known)], -np.inf
                )

        # Every group's call is queued before older results are fetched, up
        # to a window of 4 (the inputs are KB-sized index grids).
        window = InflightWindow(4, consume)
        for (L, C), group in by_shape.items():
            # Group batches run at power-of-two sizes up to the memory-model
            # cap; larger groups chunk at it.
            cap = self._batch_cap(L, C)
            for g0 in range(0, len(group), cap):
                chunk = group[g0 : g0 + cap]
                B = 1 << (len(chunk) - 1).bit_length()
                hist_idx, hist_mask = self._history_grid([it[2] for it in chunk], L, B)
                cand_idx = np.zeros((B, C), np.int64)
                for j, item in enumerate(chunk):
                    cand_idx[j, : len(item[3])] = np.maximum(item[3], 0)
                user = self._users(hist_idx, hist_mask)
                window.push((self._cosine(user, cand_idx), chunk))
        window.flush()

        results: list = [None] * len(requests)
        for req_i, (_, cand_ids) in enumerate(requests):
            parts = merged[req_i]
            s = np.concatenate([parts[k] for k in sorted(parts)])[: len(cand_ids)]
            order = np.argsort(-s, kind="stable")
            results[req_i] = [(cand_ids[i], float(s[i])) for i in order]
        return results

    def rank_dense(self, history_ids, candidate_ids) -> np.ndarray:
        """Dense ranks (1 = best) in candidate order: the offline pipeline's
        rank convention."""
        ranked = self.rank(history_ids, candidate_ids)
        score_of = {c: s for c, s in ranked}
        scores = np.array([score_of[c] for c in candidate_ids])
        return dense_rank_by_segment(scores, np.array([len(candidate_ids)]))

    def warmup(
        self,
        history_buckets: Optional[Sequence[int]] = None,
        candidate_buckets: Optional[Sequence[int]] = None,
        retrieve_k: Optional[int] = 10,
        batch_sizes: Sequence[int] = (),
    ) -> int:
        """Run one request of every (history, candidate) bucket pair, a
        top-k retrieve per history bucket and, per ``batch_sizes``, the
        ``rank_batch`` group sizes they round to, so the kernels are built
        and the libraries' per-shape set-up is done before real traffic.
        Returns the number of shapes warmed."""
        hb = list(history_buckets or self.buckets)
        cb = list(candidate_buckets or self.candidate_buckets)
        anchor = self.id_of[0]
        n = 0
        for L in hb:
            for C in cb:
                self.rank([anchor] * L, [anchor] * C)
                n += 1
            if retrieve_k:
                self.retrieve([anchor] * L, k=retrieve_k)
                n += 1
            for C in cb:
                programs = sorted(
                    {
                        min(1 << (max(int(B), 1) - 1).bit_length(), self._batch_cap(L, C))
                        for B in batch_sizes
                    }
                )
                for B in programs:
                    self.rank_batch([([anchor] * L, [anchor] * C)] * B)
                    n += 1
        return n
