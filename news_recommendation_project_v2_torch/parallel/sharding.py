"""The row-sharded news table and the data-parallel train steps.

- **The table** is row-sharded over the ``model`` axis: rank ``k`` of a row
  of the grid holds rows ``[k·N/m, (k+1)·N/m)``, the rows padded at the end
  with zeros to a multiple of ``m``. A gather of rows runs in three steps:
  each rank looks up the rows it owns, writes zeros for the others, and the
  row sums the parts with one ``all_reduce``. Only zeros are added, so the
  result is the plain gather's to the bit, and no index is exchanged: the
  batch is the same on every rank of a row. The tables are frozen (config[3]),
  so no gradient flows through the gather.
- **The steps** are data parallel. Every rank draws the same global batch
  (the same seed); data rank ``d`` takes pairs ``[d·B/n, (d+1)·B/n)`` with
  the history rows they read (``ShardedStep.shard``, on the host), gathers
  the table rows its batch reads, runs the single-device loss of
  ``train.step`` on them (both kernels on CUDA), and the gradients are
  summed over the ``data`` axis before the optimizer step. Every rank then
  holds the same reduced gradients and takes the same step: the parameters
  stay equal to the bit without a broadcast.

Dropout cannot draw the single-device masks on a mesh (each data rank draws
its own from ``seed + data_index``), so a mesh run equals a single-device
run at ``dropout_rate=0``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .mesh import Mesh


def table_sharding(mesh: Mesh, num_rows: int) -> slice:
    """The rows of a ``[num_rows, D]`` table that this rank holds, in the
    table padded to a multiple of the model axis (the slice may reach into
    the pad)."""
    per = -(-num_rows // mesh.model_size)
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The pairs of a global batch that this rank's data index takes."""
    if batch_size % mesh.data_size:
        raise ValueError(f"batch_size {batch_size} does not divide over the data axis ({mesh.data_size})")
    per = batch_size // mesh.data_size
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def replicated(mesh: Mesh, size: int) -> slice:
    """All of an axis of ``size``: what every rank holds of a replicated
    array."""
    return slice(0, size)


class ShardedTable:
    """A ``[N, D]`` table row-sharded over the model axis (see the module
    docstring); ``local`` is this rank's ``[ceil(N/m), D]`` shard on the
    device. ``shape`` is the padded table's, as the JAX package's."""

    def __init__(self, mesh: Mesh, table, device):
        table = torch.as_tensor(table)
        self.mesh = mesh
        self.num_rows, self.dim = int(table.shape[0]), int(table.shape[1])
        sl = table_sharding(mesh, self.num_rows)
        self.start, self.rows_per_shard = sl.start, sl.stop - sl.start
        local = torch.zeros((self.rows_per_shard, self.dim), dtype=table.dtype)
        part = table[sl.start : min(sl.stop, self.num_rows)]
        local[: part.shape[0]] = part
        self.local = local.to(device)
        self.shape = (self.rows_per_shard * mesh.model_size, self.dim)
        self.dtype = table.dtype

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``table[rows]`` ([R, D]) on every rank of this rank's row of the
        grid, equal to the plain gather to the bit; every rank of the row
        must call it with the same ``rows``."""
        local = rows - self.start
        owned = (local >= 0) & (local < self.rows_per_shard)
        out = self.local[local.clamp(0, self.rows_per_shard - 1)]
        out = torch.where(owned[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
        return self.mesh.sum(out, "model")

    def full(self) -> torch.Tensor:
        """The whole ``[N, D]`` table on this rank (the row's shards
        gathered), for an eval that reads every row."""
        return torch.cat(self.mesh.all_gather(self.local, "model"))[: self.num_rows]


def shard_news_table(mesh: Mesh, table, device=None) -> ShardedTable:
    """``table`` row-sharded over the mesh's model axis, this rank's shard
    on ``device`` (default: the table's)."""
    return ShardedTable(mesh, table, torch.as_tensor(table).device if device is None else device)


def _remap(rows_sorted: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Indices into ``rows_sorted`` of the table rows in ``idx`` (``-1``
    pads kept)."""
    out = np.searchsorted(rows_sorted, np.maximum(idx, 0)).astype(np.int32)
    return np.where(idx >= 0, out, -1).astype(np.int32)


class ShardedStep:
    """One data-parallel step of a single-device loss.

    ``kind`` is the global batch's layout: ``"flat"`` (``TowerTrainer``'s
    flat batches), ``"padded"``, ``"joint"`` (padded batches with the
    positives' and negatives' baselines) or ``"classification"``.
    ``loss(news_rows, query_rows, batch)`` is the single-device loss of a
    batch whose table indices address ``news_rows`` / ``query_rows``.

    ``shard(batch)`` (host, numpy; the trainers call it on their prefetch
    thread) returns this rank's ``(rows, scale, *local_batch)``; the step
    ``(optimizer, news, query, local)`` takes it on the device and returns
    the global batch's loss, the same on every rank."""

    def __init__(self, mesh: Mesh, kind: str, loss: Callable):
        if kind not in ("flat", "padded", "joint", "classification"):
            raise ValueError(f"kind {kind!r}")
        self.mesh, self.kind, self.loss = mesh, kind, loss

    def shard(self, batch: tuple) -> tuple:
        mask = batch[5] if self.kind == "joint" else batch[-1]  # the joint batch ends with its baselines
        sl = batch_sharding(self.mesh, len(mask))
        if self.kind == "classification":
            pos, neg, pair_mask = (a[sl] for a in batch)
            rows = np.unique(np.concatenate([pos.ravel(), neg[neg >= 0]]))
            local = (_remap(rows, pos), _remap(rows, neg), pair_mask)
        elif self.kind == "flat":
            local, rows = self._shard_flat(batch, sl)
        else:
            local, rows = self._shard_padded(batch, sl)
        # The losses are masked means over the batch: each rank's share is
        # its masked SUM over the GLOBAL pair count, so the data axis's sum
        # of the shares (and of their gradients) is the global mean. The
        # single-device loss divides by the local count; ``scale`` turns
        # that into the global one. Averaging the ranks' means would be
        # wrong wherever their counts differ: a last batch with pad pairs.
        count, total = float(mask[sl].sum()), float(mask.sum())
        scale = np.array(max(count, 1.0) / max(total, 1.0), np.float32)
        return (rows.astype(np.int64), scale, *local)

    def _shard_flat(self, batch: tuple, sl: slice) -> tuple[tuple, np.ndarray]:
        tok_idx, tok_rows, lens, hist_rev, pos, neg, pair_mask = batch
        b = sl.stop - sl.start
        hr = hist_rev[sl]
        hrows = np.unique(hr)  # the batch's rows these pairs read
        keep = np.isin(tok_rows, hrows)  # pad tokens (row B) fall out
        total = int(keep.sum())
        T = max(1024, 1 << int(np.ceil(np.log2(max(total, 1)))))
        ti = np.zeros(T, np.int32)
        ti[:total] = tok_idx[keep]
        tr = np.full(T, b, np.int32)
        tr[:total] = np.searchsorted(hrows, tok_rows[keep])
        ln = np.zeros(b, np.float32)
        ln[: len(hrows)] = lens[hrows]
        pos, neg = pos[sl], neg[sl]
        rows = np.unique(np.concatenate([ti, pos.ravel(), neg[neg >= 0]]))
        local = (
            _remap(rows, ti), tr, ln, np.searchsorted(hrows, hr).astype(np.int32),
            _remap(rows, pos), _remap(rows, neg), pair_mask[sl],
        )
        return local, rows

    def _shard_padded(self, batch: tuple, sl: slice) -> tuple[tuple, np.ndarray]:
        hist_idx, hist_mask, hist_rev, pos, neg, pair_mask, *baselines = batch
        b = sl.stop - sl.start
        hr = hist_rev[sl]
        hrows = np.unique(hr)
        hi = np.zeros((b, hist_idx.shape[1]), np.int32)
        hm = np.zeros((b, hist_idx.shape[1]), np.float32)
        hi[: len(hrows)] = hist_idx[hrows]
        hm[: len(hrows)] = hist_mask[hrows]
        pos, neg = pos[sl], neg[sl]
        rows = np.unique(np.concatenate([hi.ravel(), pos.ravel(), neg[neg >= 0]]))
        local = (
            _remap(rows, hi), hm, np.searchsorted(hrows, hr).astype(np.int32),
            _remap(rows, pos), _remap(rows, neg), pair_mask[sl], *(x[sl] for x in baselines),
        )
        return local, rows

    def __call__(
        self,
        optimizer: torch.optim.Optimizer,
        news: ShardedTable,
        query: Optional[ShardedTable],
        local: tuple,
    ) -> torch.Tensor:
        rows, scale, *batch = local
        news_rows = news.gather(rows)
        query_rows = news_rows if query is None or query is news else query.gather(rows)
        # The local sum over the global count. Only gradients are reduced,
        # never activations: the backward of an all_reduce on a part every
        # rank of an axis computes alike would multiply its gradient by the
        # axis size.
        loss = self.loss(news_rows, query_rows, tuple(batch)) * scale.reshape(())
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        # One all_reduce of every gradient and the loss. The optimizer's
        # global-norm clip then reads the reduced gradients.
        flat = self.mesh.sum(torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1).float()]), "data")
        offset = 0
        for p, g in zip(params, grads):
            p.grad = flat[offset : offset + g.numel()].view_as(g).to(g.dtype)
            offset += g.numel()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return flat[-1]


def make_sharded_flat_tower_train_step(mesh: Mesh, tower: torch.nn.Module, margin: float = 2.0, infonce: bool = False) -> ShardedStep:
    """The flat-token step (``train.step.flat_margin_loss`` /
    ``flat_infonce_loss``), data parallel; ``TowerTrainer``'s flat batches."""
    from ..train.step import flat_infonce_loss, flat_margin_loss  # train.trainer imports this module

    if infonce:
        return ShardedStep(mesh, "flat", lambda news, query, b: flat_infonce_loss(tower, news, b, query))
    return ShardedStep(mesh, "flat", lambda news, query, b: flat_margin_loss(tower, news, b, margin, query))


def make_sharded_tower_train_step(
    mesh: Mesh,
    tower: torch.nn.Module,
    margin: float = 2.0,
    infonce: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ShardedStep:
    """The padded step (``padded_margin_loss`` / ``padded_infonce_loss``),
    data parallel; ``TowerTrainer``'s padded batches."""
    from ..train.step import padded_infonce_loss, padded_margin_loss

    if infonce:
        return ShardedStep(mesh, "padded", lambda news, query, b: padded_infonce_loss(tower, news, b, generator, query))
    return ShardedStep(mesh, "padded", lambda news, query, b: padded_margin_loss(tower, news, b, margin, generator, query))


def make_sharded_joint_train_step(
    mesh: Mesh,
    tower: torch.nn.Module,
    margin: float = 2.0,
    blend: Optional[torch.nn.Module] = None,
    reduce: Optional[torch.nn.Module] = None,
    generator: Optional[torch.Generator] = None,
) -> ShardedStep:
    """The joint step (``joint_margin_loss``), data parallel;
    ``JointTowerTrainer``'s batches (padded, then the baselines)."""
    from ..train.step import joint_margin_loss

    return ShardedStep(
        mesh, "joint", lambda news, query, b: joint_margin_loss(tower, news, b, margin, blend, reduce, generator, query)
    )


def make_sharded_classification_step(mesh: Mesh, head: torch.nn.Module, margin: float = 2.0, infonce: bool = False) -> ShardedStep:
    """The content scorer's step (``classification_margin_loss`` /
    ``classification_infonce_loss``), data parallel."""
    from ..train.step import classification_infonce_loss, classification_margin_loss

    if infonce:
        return ShardedStep(mesh, "classification", lambda news, query, b: classification_infonce_loss(head, news, b))
    return ShardedStep(mesh, "classification", lambda news, query, b: classification_margin_loss(head, news, b, margin))


def _part_two(name: str) -> Callable:
    def not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: it comes with the second half of multi-GPU (ROADMAP.md §1)")

    not_ported.__name__ = name
    not_ported.__doc__ = f"``{name}``: not ported yet (ROADMAP.md §1, multi-GPU part 2)."
    return not_ported


make_sequence_sharded_tower_fn = _part_two("make_sequence_sharded_tower_fn")
make_sharded_e2e_train_step = _part_two("make_sharded_e2e_train_step")
shard_token_store_states = _part_two("shard_token_store_states")
store_sharding = _part_two("store_sharding")

