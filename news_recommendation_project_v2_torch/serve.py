"""Request-level serving API: rank candidate news for a user's clicked history.

A trained tower and an embedding table become a ranker: id lookup on the
host, one tower call per request (history lengths bucketed, as in the JAX
package, so the kernels see a small fixed set of shapes), cosine scoring on
the device, ranked ids back.

On a mesh of ranks (``Ranker(mesh=)``; one process a rank, as everywhere in
the port, where the JAX package serves a mesh from one process) the tables
are row-sharded over the model axis (``parallel.sharding.ShardedTable``)
and every rank builds the ranker. Rank 0 answers the calls: each first
broadcasts its host grids (a header, then the arrays) from rank 0, and every
rank runs the device work together; the other ranks serve those broadcasts
in ``Ranker.follow()`` until rank 0's ``close()``. ``rank_batch``'s groups
split over the data axis; ``retrieve`` takes a top-k on each model shard
and merges them.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .config import HISTORY_BUCKETS, IMPRESSION_BUCKETS, bucket_for
from .data.grouping import dense_rank_by_segment
from .device import resolve_device
from .utils.inflight import InflightWindow
from .utils.memory import estimate_serve_batch_cap

EPS = 1e-8  # cosine norm clamp

Tower = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # ([B,L,D], [B,L]) -> [B,D]

# Mesh serving: the calls rank 0 broadcasts, and the header's length (the
# call, k, the array count, then each array's type code and two dims).
_STOP, _NOOP, _SCORE, _RETRIEVE = range(4)
_HEADER = 16
_TYPES = (np.int64, np.float32)


class Ranker:
    """Serve ranked candidates for one user request.

    ``tower`` maps gathered history embeddings [B, L, D] and their mask
    [B, L] to user vectors [B, D]; an ``nn.Module`` tower is moved to the
    ranker's device. ``news_ids`` aligns the embedding table rows with
    external news ids (the same id-keyed contract as the embedding dumps).
    Unknown history ids are dropped; unknown candidate ids score ``-inf`` and
    rank last; ties keep candidate order.

    ``mesh`` (``parallel.mesh.Mesh``): every rank builds the ranker with the
    same arguments, rank 0 answers ``rank``, ``rank_batch`` and
    ``retrieve``, the others run ``follow()`` (the module docstring). The
    data axis must be a power of two (``rank_batch``'s group sizes are).
    A follower waits for rank 0's next call at most the process group's
    timeout, so one whose rank 0 died fails instead of hanging;
    ``keep_alive`` keeps an idle server's followers waiting.
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
        self.device = resolve_device(device)
        if isinstance(tower, nn.Module):
            tower = tower.to(self.device).eval()
        self.tower = tower
        self.mesh = mesh
        if mesh is None:
            self.news_emb = torch.as_tensor(news_emb, device=self.device)
            self.query_emb = (
                self.news_emb
                if query_news_emb is None
                else torch.as_tensor(query_news_emb, device=self.device)
            )
            self.num_news = int(self.news_emb.shape[0])
            self._news_norm = torch.linalg.norm(self.news_emb, dim=-1).clamp_min(EPS)
        else:
            from .parallel.sharding import shard_news_table

            if mesh.data_size & (mesh.data_size - 1):
                raise ValueError(
                    f"mesh serving needs a power-of-two data axis, not {mesh.data_size}: rank_batch's "
                    "group batches run at power-of-two sizes, which must split evenly over it"
                )
            self.news_emb = shard_news_table(mesh, news_emb, self.device)
            self.query_emb = (
                self.news_emb if query_news_emb is None else shard_news_table(mesh, query_news_emb, self.device)
            )
            self.num_news = self.news_emb.num_rows
            self._news_norm = torch.linalg.norm(self.news_emb.local, dim=-1).clamp_min(EPS)  # this shard's rows
            self._lock = threading.Lock()
            self._closed = False
            self._beat: Optional[tuple[threading.Event, threading.Thread]] = None
            nccl = dist.is_initialized() and dist.get_backend() == "nccl"
            self._comm_device = self.news_emb.local.device if nccl else torch.device("cpu")
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

    def _rows(self, table, idx: torch.Tensor) -> torch.Tensor:
        """``table[idx]``; a sharded table's rows gathered over the model axis."""
        if self.mesh is None:
            return table[idx]
        return table.gather(idx.reshape(-1)).view(*idx.shape, -1)

    @torch.inference_mode()
    def _users(self, hist_idx: np.ndarray, hist_mask: np.ndarray) -> torch.Tensor:
        """[B, L] history rows and mask -> [B, D] user vectors."""
        idx, mask = self._to_device(hist_idx), self._to_device(hist_mask)
        gathered = self._rows(self.query_emb, idx) * mask[..., None].to(self.query_emb.dtype)
        return self.tower(gathered, mask)

    @torch.inference_mode()
    def _cosine(self, user: torch.Tensor, cand_idx: np.ndarray) -> torch.Tensor:
        """[B, D] users x [B, C] candidate rows -> [B, C] cosine scores."""
        idx = self._to_device(cand_idx)
        nu = torch.linalg.norm(user, dim=-1).clamp_min(EPS)[:, None]
        cands = self._rows(self.news_emb, idx)
        norms = self._news_norm[idx] if self.mesh is None else torch.linalg.norm(cands, dim=-1).clamp_min(EPS)
        return torch.einsum("bcd,bd->bc", cands, user) / (nu * norms)

    # -- mesh side -------------------------------------------------------------

    def _scores(self, hist_idx: np.ndarray, hist_mask: np.ndarray, cand_idx: np.ndarray) -> torch.Tensor:
        """[B, C] cosine scores of the users of ``hist_idx`` against their
        ``cand_idx`` rows; on a mesh through every rank."""
        if self.mesh is None:
            return self._cosine(self._users(hist_idx, hist_mask), cand_idx)
        return self._call(_SCORE, (hist_idx, hist_mask, cand_idx))

    def _call(self, op: int, arrays: tuple = (), k: int = 0):
        """Rank 0: broadcast ``op`` and its arrays, then run it with the
        followers."""
        if self.mesh.rank != 0:
            raise ValueError(f"rank {self.mesh.rank} of a serving mesh follows rank 0: call follow()")
        with self._lock:
            if self._closed:
                if op == _NOOP:
                    return None
                raise ValueError("this serving mesh is closed: its followers have left")
            self._closed = op == _STOP
            if self.mesh.size == 1:
                return self._run(op, arrays, k) if op in (_SCORE, _RETRIEVE) else None
            header = torch.zeros(_HEADER, dtype=torch.int64)
            header[:3] = torch.tensor([op, k, len(arrays)])
            for i, a in enumerate(arrays):
                header[3 + 3 * i : 6 + 3 * i] = torch.tensor([_TYPES.index(a.dtype.type), *a.shape])
            self.mesh.broadcast(header.to(self._comm_device))
            arrays = tuple(np.ascontiguousarray(a, _TYPES[int(header[3 + 3 * i])]) for i, a in enumerate(arrays))
            for a in arrays:
                self.mesh.broadcast(torch.from_numpy(a).to(self._comm_device))
            return self._run(op, arrays, k) if op in (_SCORE, _RETRIEVE) else None

    def _receive(self) -> tuple[int, int, tuple]:
        header = torch.zeros(_HEADER, dtype=torch.int64, device=self._comm_device)
        self.mesh.broadcast(header)
        op, k, n = (int(x) for x in header[:3])
        arrays = []
        for i in range(n):
            code, *shape = (int(x) for x in header[3 + 3 * i : 6 + 3 * i])
            t = torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, _TYPES[code])).dtype, device=self._comm_device)
            self.mesh.broadcast(t)
            arrays.append(t.cpu().numpy())
        return op, k, tuple(arrays)

    @torch.inference_mode()
    def _run(self, op: int, arrays: tuple, k: int):
        """One broadcast call's device work, on every rank: ``_SCORE``'s
        users and cosines (a group of ``B`` rows split over the data axis
        where ``B`` divides, else run whole on every rank), or
        ``_RETRIEVE``'s top ``k`` over the sharded table."""
        mesh = self.mesh
        if op == _SCORE:
            hist_idx, hist_mask, cand_idx = arrays
            if len(hist_idx) % mesh.data_size:
                return self._cosine(self._users(hist_idx, hist_mask), cand_idx)
            per = len(hist_idx) // mesh.data_size
            sl = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            part = self._cosine(self._users(hist_idx[sl], hist_mask[sl]), cand_idx[sl])
            return torch.cat(mesh.all_gather(part.contiguous(), "data"))
        if op == _RETRIEVE:
            return self._retrieve_sharded(*arrays, k)
        raise ValueError(f"unknown mesh call {op}")

    def _retrieve_sharded(self, hist_idx: np.ndarray, hist_mask: np.ndarray, k: int) -> tuple:
        """A top-``k`` on this rank's model shard (the shard's pad rows never
        win), the ``model x k`` candidates gathered and merged: by score,
        ties by the lower global row, as one device's stable sort orders
        them."""
        table = self.news_emb
        user = self._users(hist_idx, hist_mask)[0]
        nu = torch.linalg.norm(user).clamp_min(EPS)
        scores = (table.local @ user) / (nu * self._news_norm)
        rows = table.start + torch.arange(table.rows_per_shard, device=scores.device)
        scores = torch.where(rows < self.num_news, scores, -torch.inf)
        top, idx = torch.sort(scores, descending=True, stable=True)
        kk = min(k, table.rows_per_shard)
        top = torch.cat(self.mesh.all_gather(top[:kk].contiguous(), "model"))
        idx = torch.cat(self.mesh.all_gather(rows[idx[:kk]].contiguous(), "model"))
        by_row = torch.argsort(idx, stable=True)
        top, idx = top[by_row], idx[by_row]
        order = torch.sort(top, descending=True, stable=True).indices[:k]
        return top[order], idx[order]

    def follow(self) -> int:
        """A rank other than 0: serve rank 0's broadcast calls until its
        ``close()``, whose hand-shake it joins; returns the number of calls
        served."""
        if self.mesh is None or self.mesh.rank == 0:
            raise ValueError("follow() runs on the ranks of a serving mesh other than 0")
        served = 0
        while True:
            op, k, arrays = self._receive()
            if op == _STOP:
                self.mesh.barrier()
                return served
            if op != _NOOP:
                self._run(op, arrays, k)
                served += 1

    def close(self) -> None:
        """Rank 0: stop ``keep_alive`` and wait for its thread to end, then
        release the followers (their ``follow()`` returns); a closed ranker
        refuses calls.

        ``_STOP`` is the last call rank 0 sends, and a barrier of every rank
        ends the exchange: ``close`` and ``follow`` return only once each
        rank has received it. A rank that tears its process groups down
        while another is still inside the last broadcast (the root's part of
        a broadcast ends before the others' do) can abort at exit, as rank 0
        of ``nrtorch-serve --mesh`` did under load."""
        if self.mesh is not None and self.mesh.rank == 0:
            if self._beat is not None:
                done, thread = self._beat
                done.set()
                thread.join()
            self._call(_STOP)
            self.mesh.barrier()

    def keep_alive(self, interval: float) -> threading.Event:
        """Rank 0: a daemon thread sends the followers an empty call every
        ``interval`` seconds (under the process group's timeout), so that an
        idle server's followers keep waiting; ``close`` (or setting the
        returned event) stops it, and ``close`` joins it."""
        done = threading.Event()

        def beat():
            while not done.wait(interval):
                self._call(_NOOP)

        thread = threading.Thread(target=beat, daemon=True, name="ranker-keep-alive")
        self._beat = done, thread
        thread.start()
        return done

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
        grid = self._history_grid([hist], L, 1)
        user = self._users(*grid) if self.mesh is None else None
        # The user vector is candidate-free, so chunks of the candidate axis
        # score independently (on a mesh each chunk is one call of every
        # rank). Every chunk is queued before any is fetched.
        pending = []
        start = 0
        for C in self._chunk_sizes(len(known)):
            part = known[start : start + C]
            cand_idx = np.zeros((1, C), np.int64)
            cand_idx[0, : len(part)] = np.maximum(part, 0)
            scores = self._cosine(user, cand_idx) if user is not None else self._scores(*grid, cand_idx)
            pending.append((scores[0], len(part)))
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
        kk = min(k, self.num_news)
        if self.mesh is not None:
            top, idx = self._call(_RETRIEVE, self._history_grid([hist], L, 1), kk)
        else:
            user = self._users(*self._history_grid([hist], L, 1))[0]
            nu = torch.linalg.norm(user).clamp_min(EPS)
            scores = (self.news_emb @ user) / (nu * self._news_norm)
            top, idx = torch.sort(scores, descending=True, stable=True)
            top, idx = top[:kk], idx[:kk]
        top, idx = top.cpu().numpy(), idx.cpu().numpy()
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
                if self.mesh is not None:
                    B = max(B, self.mesh.data_size)  # both powers of two: the rows split evenly
                hist_idx, hist_mask = self._history_grid([it[2] for it in chunk], L, B)
                cand_idx = np.zeros((B, C), np.int64)
                for j, item in enumerate(chunk):
                    cand_idx[j, : len(item[3])] = np.maximum(item[3], 0)
                window.push((self._scores(hist_idx, hist_mask, cand_idx), chunk))
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
