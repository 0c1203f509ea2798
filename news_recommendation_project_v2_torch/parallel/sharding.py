"""The row-sharded news table and token store, the data-parallel train
steps, and the sharded forward functions (the sequence-sharded tower, the
sharded and tensor-parallel encoder, the sharded scoring).

- **The table** is row-sharded over the ``model`` axis: rank ``k`` of a row
  of the grid holds rows ``[k·N/m, (k+1)·N/m)``, the rows padded at the end
  with zeros to a multiple of ``m``. A gather of rows runs in three steps:
  each rank looks up the rows it owns, writes zeros for the others, and the
  row sums the parts with one ``all_reduce``. Only zeros are added, so the
  result is the plain gather's to the bit, and no index is exchanged: the
  batch is the same on every rank of a row. The tables are frozen (config[3]),
  so no gradient flows through the gather.
- **The token store** (``ShardedStore``) is row-sharded over every rank of
  the world, by the same rule; its gather takes every data rank's index
  grid at once (each rank can build them all: every rank draws the same
  global batch), so one ``all_reduce`` over the world completes every data
  rank's block.
- **The steps** are data parallel. Every rank draws the same global batch
  (the same seed); data rank ``d`` takes pairs ``[d·B/n, (d+1)·B/n)`` with
  the history rows (or, end to end, the news) they read
  (``ShardedStep.shard``, on the host), gathers the rows its batch reads,
  runs the single-device loss of ``train.step`` on them (both kernels on
  CUDA), and the gradients are summed over the ``data`` axis before the
  optimizer step. Every rank then holds the same reduced gradients and
  takes the same step: the parameters stay equal to the bit without a
  broadcast.
- **The forward functions** return on every rank what the JAX package's
  global array reads: each rank computes its share and the shares are
  gathered over the axis that split them.

Dropout cannot draw the single-device masks on a mesh (each data rank draws
its own from ``seed + data_index``), so a mesh run equals a single-device
run at ``dropout_rate=0``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def store_sharding(mesh: Mesh, total_tokens: int) -> slice:
    """The rows of a flat ``[total_tokens, D]`` token store that this rank
    holds: the store row-sharded over every rank of the world (both axes,
    in rank order), padded at the end to a multiple of the world size (the
    slice may reach into the pad)."""
    per = -(-total_tokens // mesh.size)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


# Rows of a store copied to the device at a time: bounds the host memory a
# shard's upload holds beside the store (a memmap reads only these).
_UPLOAD_ROWS = 1 << 16


class ShardedStore:
    """A ``TokenStore``'s flat ``[total_tokens, D]`` states row-sharded over
    every rank of the world (``store_sharding``), in the store's own type:
    ``local`` is this rank's ``[ceil(total/world), D]`` shard on the device.
    Rows pad at the end with zeros, so the store's token indices stay valid
    (a masked slot points at row 0 and is multiplied away). ``shape`` is the
    padded store's. The store is frozen: no gradient flows through
    ``gather``."""

    def __init__(self, mesh: Mesh, states, device):
        self.mesh = mesh
        self.num_rows, self.dim = int(states.shape[0]), int(states.shape[1])
        sl = store_sharding(mesh, self.num_rows)
        self.start, self.rows_per_shard = sl.start, sl.stop - sl.start
        if isinstance(states, torch.Tensor):
            dtype = states.dtype
        else:
            dtype = torch.from_numpy(np.zeros(0, states.dtype)).dtype
        self.local = torch.zeros((self.rows_per_shard, self.dim), dtype=dtype, device=device)
        stop = min(sl.stop, self.num_rows)
        for a in range(sl.start, stop, _UPLOAD_ROWS):
            b = min(a + _UPLOAD_ROWS, stop)
            self.local[a - sl.start : b - sl.start] = torch.as_tensor(np.asarray(states[a:b]))
        self.shape = (self.rows_per_shard * mesh.size, self.dim)
        self.dtype = dtype

    def gather(self, grids: torch.Tensor) -> torch.Tensor:
        """``states[grids[data_index]]`` ([M, T, D], the store's type) on
        this rank, where ``grids`` ([data, M, T] indices into the flat
        states) holds every data rank's grid, the same on every rank.

        The index grids differ between data ranks, so the table's one shared
        gather does not serve: each rank builds the partial block of every
        data rank's grid from the rows it owns (zeros elsewhere), one SUM
        ``all_reduce`` over the world completes them all, and each rank
        keeps its own. Only zeros are added, so the block equals the plain
        gather to the bit. It moves ``data`` blocks through every rank, where
        a ``reduce_scatter`` would move one; gloo has no reduce_scatter for
        the CUDA tensors that ranks sharing a card exchange, and one exact
        rule on every backend is kept."""
        local = grids.long() - self.start
        owned = (local >= 0) & (local < self.rows_per_shard)
        out = self.local[local.clamp(0, self.rows_per_shard - 1)]
        out = torch.where(owned[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
        return self.mesh.sum(out)[self.mesh.data_index]


def shard_token_store_states(mesh: Mesh, states, device=None) -> ShardedStore:
    """A token store's flat ``[total_tokens, D]`` states (numpy, a memmap or
    a tensor) row-sharded over every rank of the mesh (``store_sharding``),
    this rank's shard on ``device`` (``None``: CUDA, as everywhere in the
    port; ``"cpu"`` on gloo ranks of the CPU)."""
    from ..device import resolve_device

    return ShardedStore(mesh, states, resolve_device(device))


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
    positives' and negatives' baselines), ``"classification"``, or the end
    to end ``"e2e"`` (``EndToEndTrainer``'s streamed batches, led by the
    [M, T, D] block) and ``"e2e_gathered"`` (its resident-store batches,
    led by the [M, T] index grid; ``sharded_store`` when the states are a
    ``ShardedStore``). ``loss(news_rows, query_rows, batch)`` is the
    single-device loss of a batch whose table indices address
    ``news_rows`` / ``query_rows``; an end-to-end loss takes the local
    batch with its [M, T, D] block in front and ignores the two tables.

    ``shard(batch)`` (host, numpy; the trainers call it on their prefetch
    thread) returns this rank's ``(rows, scale, *local_batch)``; the step
    ``(optimizer, news, query, local)`` takes it on the device and returns
    the global batch's loss, the same on every rank. For ``"e2e_gathered"``
    ``news`` is the store's states (the replicated tensor or the
    ``ShardedStore``), and ``rows`` every data rank's index grid where the
    store is sharded (empty otherwise)."""

    KINDS = ("flat", "padded", "joint", "classification", "e2e", "e2e_gathered")

    def __init__(self, mesh: Mesh, kind: str, loss: Callable, sharded_store: bool = False):
        if kind not in self.KINDS:
            raise ValueError(f"kind {kind!r}")
        self.mesh, self.kind, self.loss = mesh, kind, loss
        self.sharded_store = sharded_store and kind == "e2e_gathered"

    def shard(self, batch: tuple) -> tuple:
        mask = batch[5] if self.kind == "joint" else batch[-1]  # the joint batch ends with its baselines
        sl = batch_sharding(self.mesh, len(mask))
        if self.kind.startswith("e2e"):
            local, rows = self._shard_e2e(batch, sl)
        elif self.kind == "classification":
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

    def _e2e_union(self, batch: tuple, sl: slice) -> tuple[np.ndarray, np.ndarray]:
        """The news (rows of the global batch's M) and the history rows that
        the pairs ``sl`` read: their histories' live slots, the positives and
        the negatives (the pad pairs' row 0 too, so every index maps)."""
        _, _, hist_idx, hist_mask, hist_rev, pos, neg, _ = batch
        hrows = np.unique(hist_rev[sl])
        live = hist_idx[hrows][hist_mask[hrows] > 0]
        neg = neg[sl]
        return np.unique(np.concatenate([live, pos[sl].ravel(), neg[neg >= 0]])), hrows

    def _shard_e2e(self, batch: tuple, sl: slice) -> tuple[tuple, np.ndarray]:
        """Data rank ``d``'s end-to-end batch: the news union its pairs read,
        padded to ``m`` rows (a power of two, at most the global M; pad rows
        keep mask slot 0 live, as the trainer's do), their token block or
        index grid and mask, the histories its pairs read remapped into the
        union, and its pairs. A news item that two data ranks' pairs share
        is encoded on both: the loss is a sum over pairs, so each rank's
        gradient through it is its own pairs' share, and their sum is the
        single-device gradient (exact)."""
        tok, tok_mask, hist_idx, hist_mask, hist_rev, pos, neg, pair_mask = batch
        M, n_data = len(tok_mask), self.mesh.data_size
        per = sl.stop - sl.start
        shares = [slice(d * per, (d + 1) * per) for d in range(n_data)] if self.sharded_store else [sl]
        unions = [self._e2e_union(batch, s) for s in shares]
        m = min(M, 1 << max(3, (max(len(u) for u, _ in unions) - 1).bit_length()))
        news, hrows = unions[self.mesh.data_index if self.sharded_store else 0]

        def rows_of(u: np.ndarray, a: np.ndarray) -> np.ndarray:
            out = np.zeros((m, *a.shape[1:]), a.dtype)
            out[: len(u)] = a[u]
            return out

        mask = rows_of(news, tok_mask)
        mask[len(news) :, 0] = 1.0  # keep pad rows non-degenerate
        L = hist_idx.shape[1]
        hi = np.zeros((per, L), np.int32)
        hm = np.zeros((per, L), np.float32)
        live = hist_mask[hrows] > 0
        hi[: len(hrows)] = np.where(live, np.searchsorted(news, hist_idx[hrows]), 0)
        hm[: len(hrows)] = hist_mask[hrows]
        p, n = pos[sl], neg[sl]
        local = (
            rows_of(news, tok), mask, hi, hm, np.searchsorted(hrows, hist_rev[sl]).astype(np.int32),
            np.searchsorted(news, p).astype(np.int32),
            np.where(n >= 0, np.searchsorted(news, np.maximum(n, 0)), -1).astype(np.int32), pair_mask[sl],
        )
        grids = np.stack([rows_of(u, tok) for u, _ in unions]) if self.sharded_store else np.zeros(0, np.int64)
        return local, grids

    def __call__(
        self,
        optimizer: torch.optim.Optimizer,
        news,
        query: Optional[ShardedTable],
        local: tuple,
    ) -> torch.Tensor:
        rows, scale, *batch = local
        if self.kind.startswith("e2e"):
            if self.kind == "e2e_gathered":
                # The store is frozen: the gather's collective is outside
                # the graph, and the block enters it as an input.
                block = news.gather(rows) if self.sharded_store else news[batch[0].long()]
                batch[0] = block.float() * batch[1][..., None]
            news_rows = query_rows = None
        else:
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


def make_sharded_e2e_train_step(
    mesh: Mesh,
    token_encoder: torch.nn.Module,
    tower: torch.nn.Module,
    margin: float = 2.0,
    infonce: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ShardedStep:
    """The end-to-end step (``e2e_margin_loss`` / ``e2e_infonce_loss``) on
    streamed batches, data parallel: each data rank encodes the news its
    pairs read from its rows of the host block."""
    from ..train.step import e2e_infonce_loss, e2e_margin_loss

    if infonce:
        return ShardedStep(mesh, "e2e", lambda n, q, b: e2e_infonce_loss(token_encoder, tower, b, generator))
    return ShardedStep(mesh, "e2e", lambda n, q, b: e2e_margin_loss(token_encoder, tower, b, margin, generator))


def make_sharded_e2e_train_step_gathered(
    mesh: Mesh,
    token_encoder: torch.nn.Module,
    tower: torch.nn.Module,
    margin: float = 2.0,
    infonce: bool = False,
    sharded_store: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ShardedStep:
    """The end-to-end step on the resident store, data parallel: each data
    rank's [M, T] index grid gathers its block from the store replicated on
    every rank, or, with ``sharded_store``, from the ``ShardedStore``
    (``ShardedStore.gather``); then the loss as the streamed step's."""
    from ..train.step import e2e_infonce_loss, e2e_margin_loss

    if infonce:
        loss = lambda n, q, b: e2e_infonce_loss(token_encoder, tower, b, generator)  # noqa: E731
    else:
        loss = lambda n, q, b: e2e_margin_loss(token_encoder, tower, b, margin, generator)  # noqa: E731
    return ShardedStep(mesh, "e2e_gathered", loss, sharded_store=sharded_store)


# ---------------------------------------------------------------------------
# Forward functions over the mesh
# ---------------------------------------------------------------------------


def _on_device_of(module: torch.nn.Module, *arrays) -> tuple:
    device = next(module.parameters()).device
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def make_sequence_sharded_tower_fn(mesh: Mesh, tower: torch.nn.Module) -> Callable:
    """The tower's forward with the history axis sharded: ``fn(gathered
    [B, L, D], mask [B, L])`` (the same on every rank) runs rows
    ``B / data`` of its data index and positions ``L / model`` of its model
    index, and returns the [B, D] user vectors on every rank. Forward only,
    under ``torch.inference_mode``; ``B`` and ``L`` must divide.

    A token-local tower (``models.supports_flat_scoring``: the latent tower,
    both kernels on CUDA) runs per token on the local slice
    (``tower(x, None)``), sums its masked states and counts, adds them over
    the model axis with one ``all_reduce``, and ends with its pool epilogue.
    Any other tower reads its whole history at once (a softmax or a readout
    over positions): GSPMD gives JAX the right answer by gathering it, and
    so does the port, which ``all_gather``s the sequence over the model axis
    and runs the whole tower on each model rank; nothing is saved there.
    One ``all_gather`` over the data axis ends both."""
    from ..models.latent_attention import pool_epilogue

    def fn(gathered, mask) -> torch.Tensor:
        gathered, mask = _on_device_of(tower, gathered, mask)
        B, L = mask.shape
        if B % mesh.data_size or L % mesh.model_size:
            raise ValueError(f"[{B}, {L}] does not divide over the ({mesh.data_size}, {mesh.model_size}) mesh")
        b, l = B // mesh.data_size, L // mesh.model_size
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        cols = slice(mesh.model_index * l, (mesh.model_index + 1) * l)
        x, m = gathered[rows, cols], mask[rows, cols]
        with torch.inference_mode():
            if getattr(tower, "token_local", False):
                h = tower(x, None)
                mf = m.float()
                part = torch.cat([(h.float() * mf[..., None]).sum(dim=1), mf.sum(dim=1, keepdim=True)], dim=1)
                mesh.sum(part, "model")
                user = pool_epilogue(part[:, :-1], part[:, -1], tower.output_normalize).to(h.dtype)
            else:
                x = torch.cat(mesh.all_gather(x, "model"), dim=1)
                m = torch.cat(mesh.all_gather(m, "model"), dim=1)
                user = tower(x, m)
            return torch.cat(mesh.all_gather(user.contiguous(), "data"))

    return fn


def make_sharded_encode_fn(mesh: Mesh, encoder: torch.nn.Module) -> Callable:
    """Data-parallel encoding: ``fn(ids [B, T], mask [B, T])`` (the same on
    every rank; ``B`` divides over the data axis) encodes rows ``B / data``
    of this rank's data index, under ``torch.inference_mode``, and one
    ``all_gather`` over the data axis returns the [B, D] vectors on every
    rank. The model ranks of a data index repeat its work, as the JAX
    package's ``P("data")`` replicates over the model axis."""

    def fn(ids, mask) -> torch.Tensor:
        ids, mask = _on_device_of(encoder, ids, mask)
        rows = batch_sharding(mesh, ids.shape[0])
        with torch.inference_mode():
            out = encoder(ids[rows], mask[rows])
            return torch.cat(mesh.all_gather(out.contiguous(), "data"))

    return fn


class _ColumnParallel(torch.nn.Module):
    """A linear layer's output features split over the model axis: this
    rank holds rows ``[k·o/m, (k+1)·o/m)`` of the weight and computes those
    outputs (the bias stays whole and is sliced). With ``gather`` the
    parts are ``all_gather``ed into the whole output (a layer whose
    partner is not split); without, the next layer takes the part."""

    def __init__(self, linear: torch.nn.Linear, mesh: Mesh, gather: bool):
        super().__init__()
        per = _split(linear.out_features, mesh)
        self.cols = slice(mesh.model_index * per, (mesh.model_index + 1) * per)
        self.mesh, self.gather = mesh, gather
        self.weight = torch.nn.Parameter(linear.weight.detach()[self.cols].clone(), requires_grad=False)
        self.bias = None if linear.bias is None else torch.nn.Parameter(linear.bias.detach().clone(), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias[self.cols].to(x.dtype)
        y = F.linear(x, self.weight.to(x.dtype), bias)
        if self.gather:
            y = torch.cat(self.mesh.all_gather(y.contiguous(), "model"), dim=-1)
        return y


class _RowParallel(torch.nn.Module):
    """A linear layer's input features split over the model axis: this rank
    holds columns ``[k·i/m, (k+1)·i/m)`` of the weight and takes the matching
    part of its input (a column-parallel layer's output); the partial
    outputs are summed in float32 by one ``all_reduce`` over the model axis,
    and the bias is added once, after it."""

    def __init__(self, linear: torch.nn.Linear, mesh: Mesh):
        super().__init__()
        per = _split(linear.in_features, mesh)
        self.mesh = mesh
        cols = slice(mesh.model_index * per, (mesh.model_index + 1) * per)
        self.weight = torch.nn.Parameter(linear.weight.detach()[:, cols].clone(), requires_grad=False)
        self.bias = None if linear.bias is None else torch.nn.Parameter(linear.bias.detach().clone(), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mesh.sum(F.linear(x, self.weight.to(x.dtype)).float(), "model").to(x.dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _split(features: int, mesh: Mesh) -> int:
    if features % mesh.model_size:
        raise ValueError(f"{features} features do not split over the model axis ({mesh.model_size})")
    return features // mesh.model_size


def tensor_parallel_leaves(encoder: torch.nn.Module) -> dict[str, str]:
    """The linear layers of a ``NewsEncoder`` that ``shard_encoder_params_tp``
    splits, by their ``state_dict`` prefix: ``"column"`` or ``"row"``
    (column-parallel with the output gathered: ``"column_gather"``). These are
    the leaves the JAX package's rule (``place``'s test of a kernel's path for
    ``ffn_in``, ``q/``, ``k/``, ``v/``, ``ffn_out``, ``attn_out``) splits,
    under the port's names: the BERT/e5 layout's query, key, value and
    intermediate projections (column) and its two output projections (row);
    the decoder layout's ``q_proj`` ... ``down_proj`` match none of the
    rule's names and stay replicated; the NV-Embed head's ``to_q`` and
    ``to_kv`` match (``to_kv`` by its ``v/``) while ``to_out`` does not, so
    their outputs are gathered."""
    cfg = encoder.config
    out: dict[str, str] = {}
    if cfg.arch == "bert":
        for i in range(cfg.num_layers):
            p = f"encoder.layer.{i}."
            for name in ("attention.self.query", "attention.self.key", "attention.self.value", "intermediate.dense"):
                out[p + name] = "column"
            for name in ("attention.output.dense", "output.dense"):
                out[p + name] = "row"
    if cfg.latent_pool:
        for name in ("to_q", "to_kv"):
            out[f"latent_pool.cross_attend_blocks.0.fn.{name}"] = "column_gather"
    return out


def shard_encoder_params_tp(mesh: Mesh, encoder: torch.nn.Module, device=None) -> torch.nn.Module:
    """A tensor-parallel copy of a ``models.NewsEncoder`` for this rank,
    forward only (Megatron's layout, the JAX package's rule; see
    ``tensor_parallel_leaves``): column-parallel layers hold their share of
    the output features (the attention's heads split over the model axis),
    row-parallel ones their share of the input features, one ``all_reduce``
    over the model axis after each row-parallel layer; every other
    parameter is replicated. Every rank of a model group calls the copy
    with the same inputs and gets the whole output. The copy lives on
    ``device`` (``None``: the encoder's); ``split_leaves`` names the split
    weights."""
    import copy

    tp = copy.deepcopy(encoder)
    modules = dict(tp.named_modules())
    leaves = tensor_parallel_leaves(encoder)
    for name, kind in leaves.items():
        parent, _, attr = name.rpartition(".")
        linear = modules[name]
        part = _RowParallel(linear, mesh) if kind == "row" else _ColumnParallel(linear, mesh, kind == "column_gather")
        setattr(modules[parent], attr, part)
    if encoder.config.arch == "bert":
        heads = _split(encoder.config.num_heads, mesh)
        for layer in tp.encoder["layer"]:
            layer.num_heads = heads
    tp.split_leaves = sorted(f"{name}.weight" for name in leaves)
    return tp.to(next(encoder.parameters()).device if device is None else device)


def make_sharded_scoring_fn(mesh: Mesh, tower: torch.nn.Module) -> Callable:
    """The eval's scoring over the mesh: ``fn(news, hist_idx [R, L],
    hist_mask, cand_rev [C], cand_row [C])`` with ``news`` a ``ShardedTable``
    (row-sharded over the model axis; every rank passes the same grids, and
    ``R`` and ``C`` divide over the data axis). Each data rank runs the
    tower on its ``R / data`` history rows, the user vectors are gathered
    over the data axis, each data rank takes the cosine of its
    ``C / data`` candidate slots, and one ``all_gather`` returns the [C]
    scores on every rank. Forward only, under ``torch.inference_mode``."""
    eps = 1e-8

    def fn(news: ShardedTable, hist_idx, hist_mask, cand_rev, cand_row) -> torch.Tensor:
        device = news.local.device
        hist_idx, hist_mask, cand_rev, cand_row = (
            torch.as_tensor(a, device=device) for a in (hist_idx, hist_mask, cand_rev, cand_row)
        )
        rows = batch_sharding(mesh, hist_idx.shape[0])
        slots = batch_sharding(mesh, cand_rev.shape[0])
        with torch.inference_mode():
            hi, hm = hist_idx[rows], hist_mask[rows]
            gathered = news.gather(hi.reshape(-1).long()).view(*hi.shape, -1) * hm[..., None].to(news.dtype)
            user = torch.cat(mesh.all_gather(tower(gathered, hm).contiguous(), "data"))
            u = user[cand_row[slots].long()]
            c = news.gather(cand_rev[slots].long())
            nu = torch.linalg.norm(u, dim=-1).clamp_min(eps)
            nc = torch.linalg.norm(c, dim=-1).clamp_min(eps)
            return torch.cat(mesh.all_gather(((u * c).sum(-1) / (nu * nc)).contiguous(), "data"))

    return fn
