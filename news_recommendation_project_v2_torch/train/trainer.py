"""Training engines: ``TowerTrainer`` (a user tower, margin or InfoNCE, by the
flat-token step or the padded step), ``JointTowerTrainer`` (the tower with a
score blend and/or a reducer), ``ClassificationTrainer`` (the content
scorer) and ``EndToEndTrainer`` (a learned token encoder and the tower,
from a store of frozen token states); per-epoch resampled pairs, an epoch
eval with the MIND metrics, JSONL logs, best-checkpoint tracking, a plateau
scheduler, and save and restore of the whole training state.

The port of the JAX package's trainers: the host samples each epoch's pairs
(``data.sampling``) and builds the batches on a prefetch thread, pinned; the
steps are ``train.step``'s, and on CUDA the latent tower runs through both
hand-written kernels and their ``autograd.Function``s. The epoch eval is the
flat eval (``ops.scoring.FlatEvalPlan``, with ``device_metrics`` its fused
``metrics`` call, five scalars fetched) or the bucketed
``score_all_impressions``.

With ``mesh=`` (``parallel.mesh.Mesh``; every trainer) every rank of the
mesh runs the trainer: each draws the same epoch's pairs from the same
seed, takes its data rank's share of every batch (``parallel.sharding``'s
data-parallel steps over the row-sharded tables, or end to end over the
resident, streamed or row-sharded token store), and the evals run sharded
(``parallel.flat_eval``, or ``score_all_impressions(mesh=)``), so every
rank reads the same metrics and stops at the same epoch. Only rank 0
writes logs and checkpoints.

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` as the JAX
package builds it (``ClippedAdamW``).

``TowerTrainer``'s flat step on one CUDA card runs as CUDA graphs, one per
token bucket (``train.graphs``), with its optimizer built ``capturable``;
every other route runs its step eagerly.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..config import HISTORY_BUCKETS, TrainConfig, bucket_for, bucket_for_open
from ..data.compiler import CompiledBehaviors
from ..data.grouping import gather_end_aligned, lengths_to_offsets
from ..data.prefetch import prefetch
from ..data.sampling import neg_batch_column, sample_epoch_pairs
from ..device import resolve_device
from ..eval.device_metrics import DeviceMetricsPlan
from ..eval.ranker import compose_final_scores, history_candidate_slots
from ..models.layers import BatchDraw
from ..ops.encode import TokenStore, materialize_from_token_store, materialize_from_token_store_mesh
from ..ops.scoring import FlatEvalPlan, _auto_flat_chunk, score_all_impressions
from ..parallel.sharding import (
    ShardedTable,
    make_sharded_classification_step,
    make_sharded_e2e_train_step,
    make_sharded_e2e_train_step_gathered,
    make_sharded_flat_tower_train_step,
    make_sharded_joint_train_step,
    make_sharded_tower_train_step,
    shard_news_table,
    shard_token_store_states,
)
from ..utils import profiling
from ..utils.memory import fits_device_token_store
from .checkpoint import BestTracker, load_pytree, mean_metric, save_pytree
from .graphs import StepGraphs
from .step import (
    apply_step,
    classification_infonce_loss,
    classification_margin_loss,
    e2e_infonce_loss,
    e2e_infonce_loss_gathered,
    e2e_margin_loss,
    e2e_margin_loss_gathered,
    flat_infonce_step,
    flat_margin_step,
    joint_margin_loss,
    padded_infonce_loss,
    padded_margin_loss,
)


class ClippedAdamW(torch.optim.AdamW):
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(...))``: the
    gradients are scaled by ``max_norm / norm`` only where their global norm
    exceeds ``max_norm`` (``clip_grad_norm_`` would divide by
    ``norm + 1e-6`` always), then AdamW with decoupled weight decay on every
    parameter, as optax's ``adamw`` has no mask. The scale is chosen on the
    device: no host sync.

    A parameter whose ``.grad`` is ``None`` after the backward (one the loss
    does not reach, such as an ``as_built`` transformer layer's attention)
    counts as a zero gradient, as optax gives an inert leaf: its moments
    decay and its weight decay applies. ``torch.optim.AdamW`` would skip it.

    With ``capturable`` the step keeps its count and bias corrections on the
    device, so that a CUDA graph can capture it (``train.graphs``); its
    eager steps, a graph's warm-up, are meant, so torch's warning about them
    is off.
    """

    def __init__(self, params, lr: float, weight_decay: float, max_norm: float, capturable: bool = False):
        super().__init__(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, capturable=capturable
        )
        self.max_norm = max_norm
        self._warned_capturable_if_run_uncaptured = capturable

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            for g in grads:
                g.mul_(scale)
        return super().step(closure)


def make_optimizer(cfg: TrainConfig, params, capturable: bool = False) -> ClippedAdamW:
    return ClippedAdamW(
        params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay, max_norm=cfg.grad_clip_norm,
        capturable=capturable,
    )


class PlateauScheduler:
    """ReduceLROnPlateau(patience, factor) over the epoch val metric: sets
    the optimizer's learning rate when the metric stalls."""

    def __init__(self, cfg: TrainConfig):
        self.patience = cfg.plateau_patience
        self.factor = cfg.plateau_factor
        self.lr = cfg.learning_rate
        self.best = -np.inf
        self.stale = 0

    def update(self, optimizer: torch.optim.Optimizer, metric: Optional[float]) -> None:
        """No-op when disabled or without a metric."""
        if self.patience <= 0 or metric is None:
            return
        if metric > self.best:
            self.best = metric
            self.stale = 0
            return
        self.stale += 1
        if self.stale <= self.patience:
            return
        self.stale = 0
        self.lr *= self.factor
        for group in optimizer.param_groups:
            group["lr"] = self.lr


def _log_jsonl(log_dir: Optional[Path], fname: str, record: dict) -> None:
    if log_dir is None:
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / fname, "a") as f:
        f.write(json.dumps({"timestamp": datetime.now().isoformat(), **record}) + "\n")


def _fused_eval_metrics(
    plan_cache: dict,
    tower: torch.nn.Module,
    compiled: CompiledBehaviors,
    news_emb: torch.Tensor,
    query_emb: Optional[torch.Tensor],
    max_len: int,
    device: torch.device,
    baseline: Optional[np.ndarray] = None,
    alpha: Optional[float] = None,
    mesh=None,
) -> dict[str, float]:
    """Epoch eval through ``FlatEvalPlan.metrics``: the tower, the cosine, the
    score composition and the MIND metrics on one device, five scalars
    fetched; with a ``mesh``, through the sharded plans
    (``parallel.flat_eval``), whose only exchange is the five sums. The
    tower reads the histories from ``query_emb`` (``None``: ``news_emb``),
    the candidates come from ``news_emb``. The plans (index grids, metric
    grids, the baseline's slots) are built once per compiled set and cached
    in ``plan_cache``. Equal to ``score_all_impressions(flat_tokens=True)``
    + ``compose_final_scores(...).metrics``."""
    plans = plan_cache.get(id(compiled))
    if plans is None:
        slots, cand_rows = history_candidate_slots(compiled)
        tokens = int(np.minimum(compiled.hist_lens, max_len).sum())
        if mesh is not None:
            tokens = -(-tokens // mesh.size)  # about one rank's share
        grids = (compiled.hist_rev, compiled.hist_lens, compiled.imp_rev[slots], cand_rows)
        chunk = _auto_flat_chunk(tower.dim, tokens, device)
        baseline_slots = None if baseline is None else np.asarray(baseline, np.float32)[compiled.imp_rev]
        if mesh is None:
            fplan = FlatEvalPlan(*grids, chunk_tokens=chunk, max_len=max_len, device=device)
            mplan = DeviceMetricsPlan(
                compiled.imp_lens, compiled.labels_flat, hist_slots=slots, baseline_slots=baseline_slots, device=device
            )
        else:
            from ..parallel.flat_eval import ShardedFlatEvalPlan, ShardedMetricsPlan

            fplan = ShardedFlatEvalPlan(mesh, *grids, chunk_tokens=chunk, max_len=max_len, device=device)
            mplan = ShardedMetricsPlan(
                fplan, compiled.imp_lens, compiled.labels_flat, hist_slots=slots, baseline_slots=baseline_slots
            )
        plans = plan_cache[id(compiled)] = (fplan, mplan)
    fplan, mplan = plans
    return fplan.metrics(tower, news_emb, mplan, query_news_emb=query_emb, alpha=alpha)


class ResumableTrainer:
    """The epoch loop, and save and restore of the whole training state, so a
    resumed run continues the original one: the parameters of ``model``
    (the trained modules), the optimizer's state (moments, step counts,
    learning rate), the epoch count, the best checkpoint's score, the
    plateau scheduler, the dropout generator's state where the trainer has
    one, and in a JSON sidecar the epoch history and the numpy bit
    generator's state (the epoch sampling stream).

    A trainer sets ``model``, ``optimizer``, ``generator`` (or None),
    ``rng``, ``best``, ``plateau``, ``history``, ``cfg``, ``log_dir``,
    ``exp_name`` and ``mesh`` (or None), and defines ``train_one_epoch`` and
    ``evaluate``; ``LOG_NAME`` names its JSONL logs."""

    LOG_NAME = "final_history"

    def train(self, num_epochs: Optional[int] = None) -> list[dict]:
        """``num_epochs`` (default ``cfg.num_epochs``) epochs, each followed
        by the eval; numbering continues after a restore."""
        num_epochs = num_epochs or self.cfg.num_epochs
        done = len(self.history)
        for epoch in range(done + 1, done + num_epochs + 1):
            loss = self.train_one_epoch()
            train_scores, val_scores = self.evaluate()
            self.history.append(
                {"exp_name": self.exp_name, "epoch": epoch, "loss": loss, "train": train_scores, "val": val_scores}
            )
            _log_jsonl(
                self.log_dir,
                f"train_{self.LOG_NAME}_score.jsonl",
                {"exp_name": self.exp_name, "epoch": epoch, "scores": train_scores, "loss": loss},
            )
            if val_scores is not None:
                _log_jsonl(
                    self.log_dir,
                    f"eval_{self.LOG_NAME}_score.jsonl",
                    {"exp_name": self.exp_name, "epoch": epoch, "scores": val_scores},
                )
                self.best.update(epoch, val_scores, self.model.state_dict())
                self.plateau.update(self.optimizer, mean_metric(val_scores))
        if self.mesh is not None:
            self.mesh.barrier()  # rank 0's checkpoints are on disk before any rank reads them
        return self.history

    def _table(self, emb):
        """A table on the device; on a mesh, row-sharded over its model axis."""
        if emb is None:
            return None
        if self.mesh is not None:
            return shard_news_table(self.mesh, emb, self.device)
        return torch.as_tensor(emb, device=self.device)

    def _shard(self, batch: tuple) -> tuple:
        """This rank's share of a global batch (the batch itself off a mesh)."""
        return batch if self._mesh_step is None else self._mesh_step.shard(batch)

    @staticmethod
    def _whole(table):
        """A table whole on the device: a mesh's row shards gathered."""
        return table.full() if isinstance(table, ShardedTable) else table

    def save_training_state(self, path: Path) -> None:
        path = Path(path)
        state = {
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "epochs_done": len(self.history),
            "best_score": float(self.best.best_score),
            "plateau_lr": self.plateau.lr,
            "plateau_best": float(self.plateau.best),
            "plateau_stale": self.plateau.stale,
        }
        if self.generator is not None:
            state["generator"] = self.generator.get_state()
        save_pytree(path, state)
        # The PCG64 state holds 128-bit integers no tensor carries.
        meta = {"history": self.history, "rng_state": self.rng.bit_generator.state}
        tmp = f"{path}_meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, f"{path}_meta.json")

    def restore_training_state(self, path: Path) -> int:
        """Restore everything ``save_training_state`` wrote; returns the
        number of epochs done."""
        path = Path(path)
        state = load_pytree(path)
        self.model.load_state_dict(state["params"])
        self._load_optimizer_state(state["opt_state"])
        self.plateau.lr = float(state["plateau_lr"])
        self.plateau.best = float(state["plateau_best"])
        self.plateau.stale = int(state["plateau_stale"])
        self.best.best_score = float(state["best_score"])
        if self.generator is not None:
            self.generator.set_state(state["generator"])
        with open(f"{path}_meta.json") as f:
            meta = json.load(f)
        self.history = list(meta["history"])
        self.rng.bit_generator.state = meta["rng_state"]
        return int(state["epochs_done"])

    def _load_optimizer_state(self, opt_state: dict) -> None:
        """The optimizer's saved state, under this optimizer's own
        ``capturable``: a state saved by a route of the other kind (or by the
        flat step on the card before it ran as graphs) loads too, its step
        counts moved to where this optimizer keeps them."""
        capturable = [g["capturable"] for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(opt_state)
        for group, keep in zip(self.optimizer.param_groups, capturable):
            group["capturable"] = keep
            for p in group["params"]:
                state = self.optimizer.state.get(p, {})
                if "step" in state:
                    state["step"] = state["step"].to(p.device if keep else "cpu")


def _real_rows(batch: tuple) -> tuple:
    """A padded batch with its history block cut to the batch's U deduped
    rows: its pairs' ``hist_rev`` (pads 0) reads rows [0, U) only, so the
    block's later rows are all pad that no pair reads. U comes from
    ``hist_rev``, not from the mask: a real row may have an empty history."""
    rows = int(batch[2].max()) + 1
    return (batch[0][:rows], batch[1][:rows], *batch[2:])


def _pinned(batch: tuple, device: torch.device) -> tuple:
    """Numpy arrays as CPU tensors, pinned for CUDA so that their copies to
    the card are asynchronous (no host wait)."""
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    return tuple(t.pin_memory() for t in tensors) if device.type == "cuda" else tensors


class TowerTrainer(ResumableTrainer):
    """Trains a user tower with pairwise margin ranking or InfoNCE over each
    epoch's sampled impression pairs.

    Two routes, as in the JAX package: ``flat_train`` and ``flat_eval`` run
    the flat-token step and eval (token-local towers only: the latent tower,
    ``models.supports_flat_scoring``); with both False the step runs over
    each batch's deduped histories padded to one bucket, and the eval is the
    bucketed ``score_all_impressions``, for every tower. ``device_metrics``
    fuses the eval with the MIND metrics (``flat_eval`` only).

    ``compiled_train`` and ``compiled_val`` must be with-history views
    (``CompiledBehaviors.with_history_view``). The tables are numpy arrays or
    tensors, ``[num_news, D]`` float32. ``device=None`` means CUDA
    (``device.resolve_device``): without CUDA it raises, and
    ``device="cpu"`` runs the kernels' plain versions. The history tokens
    are looked up in ``query_news_emb_train`` and ``query_news_emb_val``
    (e5's query-side tables), the candidates in the news tables; a query
    table left ``None`` is its split's news table. Dropout, where the tower
    has it, draws from ``generator``, seeded from ``cfg.seed`` (plus the
    data index on a mesh). ``mesh=`` trains data parallel over the ranks of
    a ``parallel.mesh.Mesh`` (the module docstring); ``cfg.batch_size``
    must divide over its data axis.

    The flat step on a CUDA device without a mesh runs through
    ``train.graphs.StepGraphs`` (one CUDA graph per token bucket, the
    optimizer ``capturable``); ``set_tables`` and ``restore_training_state``
    drop its graphs, and a changed learning rate does too.
    """

    def __init__(
        self,
        tower: torch.nn.Module,
        compiled_train: CompiledBehaviors,
        news_emb_train,
        compiled_val: Optional[CompiledBehaviors] = None,
        news_emb_val=None,
        cfg: TrainConfig = TrainConfig(),
        query_news_emb_train=None,
        query_news_emb_val=None,
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "",
        buckets: tuple[int, ...] = HISTORY_BUCKETS,
        mesh=None,
        flat_eval: bool = True,
        flat_train: bool = True,
        device_metrics: bool = False,
        device=None,
    ):
        if mesh is not None and cfg.batch_size % mesh.data_size:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide over the mesh's data axis ({mesh.data_size})")
        if (flat_train or flat_eval) and not getattr(tower, "token_local", False):
            raise ValueError(
                f"flat_train and flat_eval need a token-local tower (models.supports_flat_scoring: "
                f"the latent tower); pass flat_train=False, flat_eval=False for {type(tower).__name__}"
            )
        if device_metrics and not flat_eval:
            raise ValueError("device_metrics rides the flat eval (FlatEvalPlan.metrics): it needs flat_eval=True")
        if len(compiled_train.hist_lens) != compiled_train.num_rows:
            raise ValueError("TowerTrainer needs a with-history view (every row must have history)")
        if cfg.loss not in ("margin", "infonce"):
            raise ValueError(f"loss {cfg.loss!r}: want 'margin' or 'infonce'")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tower = tower.to(self.device)
        self.model = self._trained_model()
        self.cfg = cfg
        self.ct = compiled_train
        self.cv = compiled_val
        self._graphs: Optional[StepGraphs] = None
        self.set_tables(news_emb_train, news_emb_val, query_news_emb_train, query_news_emb_val)
        writer = mesh is None or mesh.rank == 0
        self.log_dir = log_dir if writer else None
        self.exp_name = exp_name
        self.buckets = buckets
        self.rng = np.random.default_rng(cfg.seed)
        seed = cfg.seed if mesh is None else cfg.seed + mesh.data_index
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        graphed = flat_train and mesh is None and self.device.type == "cuda"
        self.optimizer = make_optimizer(cfg, self.model.parameters(), capturable=graphed)
        if graphed:
            self._graphs = StepGraphs(self.optimizer, self.device)
        self.best = BestTracker(ckpt_dir, exp_name, write=writer)
        self.plateau = PlateauScheduler(cfg)
        self.history: list[dict] = []
        self._hist_offsets = lengths_to_offsets(compiled_train.hist_lens)
        self.flat_train = flat_train
        self.flat_eval = flat_eval
        self.device_metrics = device_metrics
        self._fused_plans: dict = {}
        self._mesh_step = None if mesh is None else self._sharded_step()

    def set_tables(self, news_emb_train, news_emb_val=None, query_news_emb_train=None, query_news_emb_val=None) -> None:
        """The splits' tables, as the constructor takes them: a corpus encoded
        anew takes the old tables' place, rows in the same news order. The
        eval's plans (index and metric grids, built once per split) read the
        tables at each call, so they stay; the train step's graphs hold the
        old tables' addresses, so they go."""
        if self._graphs is not None:
            self._graphs.clear()
        self.news_emb_train = self._table(news_emb_train)
        self.news_emb_val = self._table(news_emb_val)
        self.query_train = self.news_emb_train if query_news_emb_train is None else self._table(query_news_emb_train)
        self.query_val = self.news_emb_val if query_news_emb_val is None else self._table(query_news_emb_val)

    def _trained_model(self) -> torch.nn.Module:
        """The module the optimizer steps and the checkpoint saves: the tower."""
        return self.tower

    def restore_training_state(self, path: Path) -> int:
        done = super().restore_training_state(path)
        if self._graphs is not None:
            self._graphs.clear()  # the optimizer's state is new tensors
        return done

    def _sharded_step(self):
        """The data-parallel step of ``_train_step``'s loss."""
        cfg, infonce = self.cfg, self.cfg.loss == "infonce"
        if self.flat_train:
            return make_sharded_flat_tower_train_step(self.mesh, self.tower, cfg.margin, infonce)
        return make_sharded_tower_train_step(self.mesh, self.tower, cfg.margin, infonce, self.generator)

    # ------------------------------------------------------------------
    # Host input pipeline
    # ------------------------------------------------------------------

    def _epoch_pairs(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        cfg = self.cfg
        return sample_epoch_pairs(
            self.rng,
            self.ct.imp_rev,
            self.ct.imp_lens,
            self.ct.labels_flat,
            loss=cfg.loss,
            num_neg_per_pos=cfg.num_neg_per_pos,
            max_neg_ratio=cfg.max_neg_ratio,
            max_pos_ratio=cfg.max_pos_ratio,
            batch_size=cfg.batch_size,
        )

    def _epoch_batches(self) -> Iterator[tuple]:
        """One epoch's padded batches as numpy arrays: each batch's deduped
        histories (``np.unique`` of its rows), end-aligned (the most recent
        clicks) and padded to the bucket of its longest, as a
        ``[batch_size, L]`` index block and mask (rows past the deduped ones
        all pad), then the pair columns padded to ``batch_size``. Equal to the
        JAX package's, array for array, from the same generator state."""
        pairs, negs = self._epoch_pairs()
        B = self.cfg.batch_size
        for start in range(0, pairs.shape[1], B):
            stop = min(start + B, pairs.shape[1])
            uniq_rows, rev = np.unique(pairs[-1, start:stop], return_inverse=True)
            L = bucket_for(int(self.ct.hist_lens[uniq_rows].max()), self.buckets)
            hist_idx, hist_mask = gather_end_aligned(
                self.ct.hist_rev,
                self._hist_offsets[uniq_rows + 1],
                self.ct.hist_lens[uniq_rows],
                L,
                out_rows=B,
            )
            pad = B - (stop - start)
            yield (
                hist_idx,
                hist_mask,
                np.pad(rev.astype(np.int32), (0, pad)),
                np.pad(pairs[0, start:stop].astype(np.int32), (0, pad)),
                neg_batch_column(pairs, negs, start, stop, pad),
                np.pad(np.ones(stop - start, np.float32), (0, pad)),
            )

    def _epoch_batches_flat(self) -> Iterator[tuple]:
        """One epoch's batches as numpy arrays: each batch's deduped rows'
        flat token stream (the most recent ``buckets[-1]`` clicks of a row),
        padded to the next power of two of at least 1,024 tokens, with the
        pairs padded to ``batch_size``. Equal to the JAX package's, array for
        array, from the same generator state."""
        cap = self.buckets[-1]
        offsets = self._hist_offsets
        pairs, negs = self._epoch_pairs()
        B = self.cfg.batch_size
        for start in range(0, pairs.shape[1], B):
            stop = min(start + B, pairs.shape[1])
            pos = pairs[0, start:stop]
            rows = pairs[-1, start:stop]
            uniq_rows, rev = np.unique(rows, return_inverse=True)
            lens = np.minimum(self.ct.hist_lens[uniq_rows], cap).astype(np.int64)
            ends = offsets[uniq_rows + 1]
            keep_off = lengths_to_offsets(lens)
            total = int(keep_off[-1])
            sel = np.repeat(ends - lens, lens) + (np.arange(total) - np.repeat(keep_off[:-1], lens))
            T = max(1024, 1 << int(np.ceil(np.log2(max(total, 1)))))
            tok_idx = np.zeros(T, np.int32)
            tok_idx[:total] = self.ct.hist_rev[sel]
            tok_rows = np.full(T, B, np.int32)  # out-of-range -> dropped
            tok_rows[:total] = np.repeat(np.arange(len(uniq_rows), dtype=np.int32), lens)
            lens_arr = np.zeros(B, np.float32)
            lens_arr[: len(uniq_rows)] = lens
            pad = B - (stop - start)
            neg_padded = neg_batch_column(pairs, negs, start, stop, pad)
            yield (
                tok_idx,
                tok_rows,
                lens_arr,
                np.pad(rev.astype(np.int32), (0, pad)),
                np.pad(pos.astype(np.int32), (0, pad)),
                neg_padded,
                np.pad(np.ones(stop - start, np.float32), (0, pad)),
            )

    def _host_batches(self) -> Iterator[tuple[float, tuple]]:
        """``(pair count, batch)`` per step, the batch as pinned CPU tensors
        (built on the prefetch thread). The padded step on one device takes
        the history block's U real rows (``_real_rows``), not all
        ``batch_size``; a mesh step takes its rank's share of the whole
        block."""
        batches = self._epoch_batches_flat() if self.flat_train else self._epoch_batches()
        trim = not self.flat_train and self._mesh_step is None
        for batch in batches:
            local = _real_rows(batch) if trim else self._shard(batch)
            self._count_tokens(local)
            yield float(batch[-1].sum()), _pinned(local, self.device)

    def _count_tokens(self, local: tuple) -> None:
        """Where it records (``utils.profiling``), count a step's real and
        computed history tokens as its batch is handed over (this rank's
        share on a mesh): the flat stream's real tokens against its length,
        or the padded block's mask against its ``rows x L``, and the padded
        block's rows (``train.rows_computed``). On the producer thread, so
        that the loop gives up no GIL to count."""
        if not profiling.active():
            return
        local = local if self._mesh_step is None else local[2:]  # after the shard's rows and scale
        if self.flat_train:
            real, computed = local[2].sum(), local[0].size
        else:
            real, computed = local[1].sum(), local[1].size
            profiling.count("train.rows_computed", local[1].shape[0])
        profiling.count("train.tokens_real", int(real))
        profiling.count("train.tokens_computed", int(computed))

    def _flat_step(self, batch) -> torch.Tensor:
        """One eager flat step on the current tables."""
        cfg, news, query = self.cfg, self.news_emb_train, self.query_train
        if cfg.loss == "infonce":
            return flat_infonce_step(self.tower, self.optimizer, news, batch, query)
        return flat_margin_step(self.tower, self.optimizer, news, batch, cfg.margin, query)

    def _to_device(self, batch: tuple) -> tuple:
        return tuple(t.to(self.device, non_blocking=True) for t in batch)

    def _train_step(self, batch) -> torch.Tensor:
        """One step on a host batch (pinned on CUDA): the graphs copy it
        into their static inputs, every other route to fresh device tensors."""
        if self._graphs is not None:
            return self._graphs(self._flat_step, batch)
        batch = self._to_device(batch)
        cfg, tower, news, query = self.cfg, self.tower, self.news_emb_train, self.query_train
        if self._mesh_step is not None:
            return self._mesh_step(self.optimizer, news, query, batch)
        if self.flat_train:
            return self._flat_step(batch)
        # The block holds the batch's real rows (``_real_rows``); dropout draws over all ``batch_size``.
        draw = BatchDraw(self.generator, cfg.batch_size)
        if cfg.loss == "infonce":
            return apply_step(self.optimizer, padded_infonce_loss(tower, news, batch, draw, query))
        return apply_step(self.optimizer, padded_margin_loss(tower, news, batch, cfg.margin, draw, query))

    @profiling.unit("train.epoch")
    def train_one_epoch(self) -> float:
        """One epoch of steps; returns the pair-weighted mean loss. The loss
        is fetched every ``loss_sync_every`` steps (each fetch waits for the
        card) and every step's loss is recorded.

        Where it records (``utils.profiling``), the spans ``train.wait_batch``
        (blocked on the prefetch queue), ``train.build_batch`` (the producer
        thread), ``train.step`` (the copies and the step queued) and
        ``train.loss_fetch``, and the counters ``train.steps``,
        ``train.pairs``, (``_count_tokens``) ``train.tokens_real``,
        ``train.tokens_computed`` and, padded, ``train.rows_computed``, and
        on the graphed route ``train.graph_captures`` and
        ``train.graph_replays`` (``train.graphs``)."""
        sync = max(1, self.cfg.loss_sync_every)
        losses, counts = [], []
        for count, batch in prefetch(self._host_batches(), spans=("train.wait_batch", "train.build_batch")):
            with profiling.span("train.step"):
                loss = self._train_step(batch)
            profiling.count("train.steps")
            profiling.count("train.pairs", int(count))
            losses.append(loss)
            if len(losses) % sync == 0:
                with profiling.span("train.loss_fetch"):
                    losses[-1] = float(losses[-1])
            counts.append(count)
        with profiling.span("train.loss_fetch"):
            losses = [float(x) for x in losses]
        return float(np.dot(losses, counts) / np.sum(counts))

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _eval_split(
        self,
        compiled: CompiledBehaviors,
        news_emb: torch.Tensor,
        query_emb: Optional[torch.Tensor],
        baseline: Optional[np.ndarray] = None,
        alpha: Optional[float] = None,
    ) -> dict[str, float]:
        """One split's metrics: the tower over the histories read from
        ``query_emb``, its cosine scores against ``news_emb`` on the history
        slots, composed with ``baseline`` (per unique news) and ``alpha`` as
        ``eval.ranker.compose_final_scores`` does."""
        max_len = self.buckets[-1]  # the train step's cap, so both see the same histories
        if self.device_metrics:
            return _fused_eval_metrics(
                self._fused_plans, self.tower, compiled, news_emb, query_emb, max_len, self.device, baseline, alpha,
                self.mesh,
            )
        slots, cand_rows = history_candidate_slots(compiled)
        scores = score_all_impressions(
            self.tower,
            news_emb,
            compiled.hist_rev,
            compiled.hist_lens,
            compiled.imp_rev[slots],
            cand_rows,
            query_news_emb=query_emb,
            batch_size=self.cfg.batch_size,
            buckets=self.buckets,
            flat_tokens=self.flat_eval,
            flat_max_len=max_len,
            mesh=self.mesh,
            device=self.device,
        )
        return compose_final_scores(compiled, history_scores=scores, baseline_scores=baseline, alpha=alpha).metrics

    def _eval_tables(self, news, query) -> tuple[torch.Tensor, torch.Tensor]:
        """A split's (news, query) tables whole on the device, once per eval."""
        full = self._whole(news)
        return full, full if query is news else self._whole(query)

    @profiling.unit("eval.evaluate")
    def evaluate(self) -> tuple[dict, Optional[dict]]:
        train_scores = self._eval_split(self.ct, *self._eval_tables(self.news_emb_train, self.query_train))
        val_scores = (
            self._eval_split(self.cv, *self._eval_tables(self.news_emb_val, self.query_val))
            if self.cv is not None
            else None
        )
        return train_scores, val_scores


class JointTowerTrainer(TowerTrainer):
    """Trains the tower jointly with a ``WeightedSumModel`` blend (each
    cosine blended with the candidate's content baseline, e.g.
    ``ClassificationTrainer.baseline_scores``) and/or a ``ReducingModel``
    projector, under one ``ClippedAdamW`` over all of them: margin loss only,
    the padded step.

    With a reducer, both tables are reduced at eval, the history (query)
    table and the candidate table, as in training. With a blend, the history
    slots
    score ``sigmoid(alpha) * cos + (1 - sigmoid(alpha)) * baseline`` (through
    ``compose_final_scores``, or ``DeviceMetricsPlan`` with the flat eval of
    the latent tower). ``baseline_train`` and ``baseline_val`` are per unique
    news of their split; the blend needs ``baseline_train``. ``model`` is a
    ``ModuleDict`` of ``tower``, ``blend`` and ``reduce``.
    """

    def __init__(
        self,
        tower: torch.nn.Module,
        compiled_train: CompiledBehaviors,
        news_emb_train,
        blend: Optional[torch.nn.Module] = None,
        reduce: Optional[torch.nn.Module] = None,
        baseline_train: Optional[np.ndarray] = None,
        baseline_val: Optional[np.ndarray] = None,
        **kwargs,
    ):
        cfg = kwargs.get("cfg", TrainConfig())
        if cfg.loss != "margin":
            raise ValueError("JointTowerTrainer trains the margin loss only; use TowerTrainer for InfoNCE")
        if kwargs.setdefault("flat_train", False):
            raise ValueError("JointTowerTrainer runs the padded joint step; flat_train applies to TowerTrainer")
        if blend is not None and baseline_train is None:
            raise ValueError("a blend needs baseline_train")
        self.blend, self.reduce = blend, reduce
        self.baseline_train = baseline_train
        self.baseline_val = baseline_val
        super().__init__(tower, compiled_train, news_emb_train, **kwargs)

    def _trained_model(self) -> torch.nn.Module:
        parts = {"tower": self.tower}
        if self.blend is not None:
            parts["blend"] = self.blend
        if self.reduce is not None:
            parts["reduce"] = self.reduce
        return torch.nn.ModuleDict(parts).to(self.device)

    def _host_batches(self) -> Iterator[tuple[float, tuple]]:
        """The padded batches with the baselines of each pair's positive and
        negative appended (zeros without a baseline)."""
        baseline = self.baseline_train
        if baseline is None:
            baseline = np.zeros(self.ct.num_news, np.float32)
        for batch in self._epoch_batches():
            pos, neg = batch[3], batch[4]
            extras = (baseline[pos].astype(np.float32), baseline[neg].astype(np.float32))
            local = self._shard(batch + extras)
            self._count_tokens(local)
            yield float(batch[-1].sum()), _pinned(local, self.device)

    def _sharded_step(self):
        return make_sharded_joint_train_step(
            self.mesh, self.tower, self.cfg.margin, self.blend, self.reduce, self.generator
        )

    def _train_step(self, batch) -> torch.Tensor:
        batch = self._to_device(batch)
        if self._mesh_step is not None:
            return self._mesh_step(self.optimizer, self.news_emb_train, self.query_train, batch)
        loss = joint_margin_loss(
            self.tower, self.news_emb_train, batch, self.cfg.margin, self.blend, self.reduce, self.generator,
            self.query_train,
        )
        return apply_step(self.optimizer, loss)

    def _alpha(self) -> Optional[float]:
        return None if self.blend is None else float(torch.sigmoid(self.blend.alpha.detach()))

    @torch.no_grad()
    def _reduced(self, news: torch.Tensor, query: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Both tables through the reducer (a query table that is the news
        table once)."""
        if self.reduce is None:
            return news, query
        reduced = self.reduce(news)
        return reduced, reduced if query is news else self.reduce(query)

    @profiling.unit("eval.evaluate")
    def evaluate(self) -> tuple[dict, Optional[dict]]:
        alpha = self._alpha()
        train_scores = self._eval_split(
            self.ct, *self._reduced(*self._eval_tables(self.news_emb_train, self.query_train)), self.baseline_train, alpha
        )
        val_scores = (
            self._eval_split(
                self.cv, *self._reduced(*self._eval_tables(self.news_emb_val, self.query_val)), self.baseline_val, alpha
            )
            if self.cv is not None
            else None
        )
        return train_scores, val_scores


class ClassificationTrainer(ResumableTrainer):
    """Trains the content-only scorer (``ClassificationHead``) on sampled
    positive and negative candidates, margin loss or InfoNCE, each epoch's
    pairs in a full permutation. Its eval ranks every candidate by the head's
    score alone; ``baseline_scores`` gives those scores per unique news, the
    baseline ``JointTowerTrainer``'s blend takes. ``device=None`` means
    CUDA; ``mesh=`` trains data parallel, as ``TowerTrainer`` does."""

    LOG_NAME = "classification"

    def __init__(
        self,
        head: torch.nn.Module,
        compiled_train: CompiledBehaviors,
        news_emb_train,
        compiled_val: Optional[CompiledBehaviors] = None,
        news_emb_val=None,
        cfg: TrainConfig = TrainConfig(),
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "",
        mesh=None,
        device=None,
    ):
        if mesh is not None and cfg.batch_size % mesh.data_size:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide over the mesh's data axis ({mesh.data_size})")
        if cfg.loss not in ("margin", "infonce"):
            raise ValueError(f"loss {cfg.loss!r}: want 'margin' or 'infonce'")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.head = self.model = head.to(self.device)
        self.cfg = cfg
        self.ct = compiled_train
        self.cv = compiled_val
        self.news_emb_train = self._table(news_emb_train)
        self.news_emb_val = self._table(news_emb_val)
        writer = mesh is None or mesh.rank == 0
        self.log_dir = log_dir if writer else None
        self.exp_name = exp_name
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = None  # the head has no dropout
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.best = BestTracker(ckpt_dir, exp_name, write=writer)
        self.plateau = PlateauScheduler(cfg)
        self.history: list[dict] = []
        self._mesh_step = (
            None
            if mesh is None
            else make_sharded_classification_step(mesh, head, cfg.margin, cfg.loss == "infonce")
        )

    def _host_batches(self) -> Iterator[tuple[float, tuple]]:
        """``(pair count, (pos, neg, pair_mask))`` per step, padded to
        ``batch_size``, as pinned CPU tensors."""
        cfg = self.cfg
        pairs, negs = sample_epoch_pairs(
            self.rng,
            self.ct.imp_rev,
            self.ct.imp_lens,
            self.ct.labels_flat,
            loss=cfg.loss,
            num_neg_per_pos=cfg.num_neg_per_pos,
            batch_size=None,
        )
        B = cfg.batch_size
        for start in range(0, pairs.shape[1], B):
            stop = min(start + B, pairs.shape[1])
            pad = B - (stop - start)
            batch = (
                np.pad(pairs[0, start:stop].astype(np.int32), (0, pad)),
                neg_batch_column(pairs, negs, start, stop, pad),
                np.pad(np.ones(stop - start, np.float32), (0, pad)),
            )
            yield float(stop - start), _pinned(self._shard(batch), self.device)

    def train_one_epoch(self) -> float:
        """One epoch; returns the pair-weighted mean loss (fetched every
        ``loss_sync_every`` steps, every step's loss recorded)."""
        sync = max(1, self.cfg.loss_sync_every)
        losses, counts = [], []
        for count, batch in prefetch(self._host_batches()):
            batch = tuple(t.to(self.device, non_blocking=True) for t in batch)
            if self._mesh_step is not None:
                losses.append(self._mesh_step(self.optimizer, self.news_emb_train, None, batch))
            else:
                if self.cfg.loss == "infonce":
                    loss = classification_infonce_loss(self.head, self.news_emb_train, batch)
                else:
                    loss = classification_margin_loss(self.head, self.news_emb_train, batch, self.cfg.margin)
                losses.append(apply_step(self.optimizer, loss))
            if len(losses) % sync == 0:
                losses[-1] = float(losses[-1])
            counts.append(count)
        losses = [float(x) for x in losses]
        return float(np.dot(losses, counts) / np.sum(counts))

    @torch.inference_mode()
    def baseline_scores(self, news_emb) -> np.ndarray:
        """The head's score of every row of ``news_emb`` (per unique news),
        float32 on the host."""
        return self.head(torch.as_tensor(news_emb, device=self.device))[:, 0].float().cpu().numpy()

    def _eval_split(self, compiled: CompiledBehaviors, news_emb) -> dict[str, float]:
        preds = self.baseline_scores(news_emb)[: compiled.num_news]
        return compose_final_scores(compiled, baseline_scores=preds).metrics

    def evaluate(self) -> tuple[dict, Optional[dict]]:
        train_scores = self._eval_split(self.ct, self._whole(self.news_emb_train))
        val_scores = self._eval_split(self.cv, self._whole(self.news_emb_val)) if self.cv is not None else None
        return train_scores, val_scores


class EndToEndTrainer(ResumableTrainer):
    """Trains a learned token encoder (``models.TokenAttentionPool``) and the
    user tower together from a ``TokenStore`` of frozen per-token states
    (config[2]): each batch's distinct news go through the encoder, their
    vectors feed the histories and the candidates, and the gradient reaches
    both modules. Margin or InfoNCE (``cfg.loss``).

    ``device_store`` (``None``: ``utils.memory.fits_device_token_store`` on
    the device's memory) keeps the store's flat states on the card, in their
    own type (a float16 store stays float16), and a step uploads index grids
    and gathers its [M, T, D] block there; otherwise each step's block is
    gathered on the host, pinned on the prefetch thread and copied without
    blocking. Both routes give the same steps.

    Epochs: a non-finite loss raises ``FloatingPointError``; with
    ``eval_each_epoch`` the learned news embeddings are materialized
    (``materialize_news_embeddings``; ``val_token_store`` streams through
    the host route) and the MIND metrics computed (``flat_eval`` /
    ``device_metrics`` as in ``TowerTrainer``); with ``ckpt_dir`` every epoch
    writes ``Epoch_N`` (and, with a val split, the best by its metrics), and
    ``remote_sync(path)`` is called with each. ``model`` is the ``ModuleDict``
    of ``token_encoder`` and ``tower``; ``device=None`` means CUDA.

    ``mesh=`` trains data parallel (``parallel.sharding``'s e2e steps;
    ``cfg.batch_size`` must divide over the data axis). ``device_store=None``
    then also holds when the store fits one card once row-sharded over the
    world (``fits_device_token_store(num_shards=)``), and ``shard_store``
    (``None``: a resident store that does not fit one card) row-shards it
    over every rank (``ShardedStore``) instead of copying it to each. The
    train store's embeddings materialize through
    ``materialize_from_token_store_mesh`` where the store is resident."""

    TOKEN_BUCKETS = (64, 128, 256, 512)
    UNIQUE_BUCKETS = (128, 256, 512, 1024, 2048, 4096)

    def __init__(
        self,
        token_encoder: torch.nn.Module,
        tower: torch.nn.Module,
        compiled_train: CompiledBehaviors,
        token_store: TokenStore,
        cfg: TrainConfig = TrainConfig(),
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "",
        buckets: tuple[int, ...] = HISTORY_BUCKETS,
        max_token_len: int = 512,
        remote_sync: Optional[Callable[[Path], None]] = None,
        compiled_val: Optional[CompiledBehaviors] = None,
        val_token_store: Optional[TokenStore] = None,
        eval_each_epoch: bool = False,
        flat_eval: bool = False,
        device_metrics: bool = False,
        device_store: Optional[bool] = None,
        mesh=None,
        shard_store: Optional[bool] = None,
        device=None,
    ):
        if shard_store and mesh is None:
            raise ValueError("shard_store needs a mesh: the store shards over its ranks")
        if shard_store and device_store is False:
            raise ValueError("shard_store=True needs the resident store (device_store must not be False)")
        if mesh is not None and cfg.batch_size % mesh.data_size:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide over the mesh's data axis ({mesh.data_size})")
        if len(compiled_train.hist_lens) != compiled_train.num_rows:
            raise ValueError("EndToEndTrainer needs a with-history view (every row must have history)")
        if (compiled_val is None) != (val_token_store is None):
            raise ValueError("compiled_val and val_token_store come together (val scores use the val corpus)")
        if device_metrics and not flat_eval:
            raise ValueError("device_metrics rides the flat eval (FlatEvalPlan.metrics): it needs flat_eval=True")
        if flat_eval and not getattr(tower, "token_local", False):
            raise ValueError(f"flat_eval needs a token-local tower (models.supports_flat_scoring), not {type(tower).__name__}")
        if cfg.loss not in ("margin", "infonce"):
            raise ValueError(f"loss {cfg.loss!r}: want 'margin' or 'infonce'")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = torch.nn.ModuleDict({"token_encoder": token_encoder, "tower": tower}).to(self.device)
        self.token_encoder, self.tower = self.model["token_encoder"], self.model["tower"]
        self.ct, self.store = compiled_train, token_store
        self.cv, self.store_val = compiled_val, val_token_store
        self.cfg = cfg
        writer = mesh is None or mesh.rank == 0
        self.log_dir = log_dir if writer else None
        self.exp_name = exp_name
        self.buckets = buckets
        self.max_token_len = max_token_len
        self.remote_sync = remote_sync if writer else None
        self.eval_each_epoch = eval_each_epoch
        self.flat_eval = flat_eval
        self.device_metrics = device_metrics
        self._fused_plans: dict = {}
        self.rng = np.random.default_rng(cfg.seed)
        seed = cfg.seed if mesh is None else cfg.seed + mesh.data_index
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.best = BestTracker(ckpt_dir, exp_name, write=writer)
        self.plateau = PlateauScheduler(cfg)  # saved with the state; the e2e epochs take no plateau step
        self.history: list[dict] = []
        self._hist_offsets = lengths_to_offsets(compiled_train.hist_lens)
        states = token_store.states
        geometry = (int(token_store.offsets[-1]), int(states.shape[1]), states.dtype.itemsize)
        fits_one = fits_device_token_store(*geometry, device=self.device)
        if device_store is None:
            device_store = fits_one or (
                mesh is not None and fits_device_token_store(*geometry, num_shards=mesh.size, device=self.device)
            )
        if shard_store is None:
            # Replicated where it fits: its gather needs no collective.
            shard_store = bool(device_store) and mesh is not None and not fits_one
        self.device_store = bool(device_store)
        self.store_sharded = bool(shard_store) and self.device_store
        if self.store_sharded:
            self._dev_states = shard_token_store_states(mesh, states, self.device)
        else:
            self._dev_states = _upload_states(states, self.device) if self.device_store else None
        self._mesh_step = None
        if mesh is not None:
            infonce = cfg.loss == "infonce"
            enc, tower = self.token_encoder, self.tower
            if self.device_store:
                self._mesh_step = make_sharded_e2e_train_step_gathered(
                    mesh, enc, tower, cfg.margin, infonce, self.store_sharded, self.generator
                )
            else:
                self._mesh_step = make_sharded_e2e_train_step(mesh, enc, tower, cfg.margin, infonce, self.generator)

    # ------------------------------------------------------------------
    # Host input pipeline
    # ------------------------------------------------------------------

    def _epoch_batches(self) -> Iterator[tuple]:
        """One epoch's batches as numpy arrays, equal to the JAX package's
        array for array from the same generator state: the union of the
        batch's histories and candidates (``np.unique``) padded to an
        ``UNIQUE_BUCKETS`` size M that never truncates (``bucket_for_open``);
        its token states (the first ``max_token_len`` of each news, padded to
        a ``TOKEN_BUCKETS`` width T) as a float32 [M, T, D] block, or with
        ``device_store`` as [M, T] int32 indices into the flat states; the
        [M, T] mask; the deduped histories end-aligned into [batch_size, L]
        indices into M; then the pair columns, indices into M too, padded
        to ``batch_size``."""
        cfg = self.cfg
        pairs, negs = sample_epoch_pairs(
            self.rng, self.ct.imp_rev, self.ct.imp_lens, self.ct.labels_flat,
            loss=cfg.loss, num_neg_per_pos=cfg.num_neg_per_pos,
            max_neg_ratio=cfg.max_neg_ratio, max_pos_ratio=cfg.max_pos_ratio,
            batch_size=cfg.batch_size,
        )
        B = cfg.batch_size
        offsets = self._hist_offsets
        for start in range(0, pairs.shape[1], B):
            stop = min(start + B, pairs.shape[1])
            pos = pairs[0, start:stop]
            rows = pairs[-1, start:stop]
            if negs is None:
                neg = pairs[1, start:stop]
                neg_union = neg
            else:
                neg = negs[:, start:stop].T  # [b, K], -1 pads
                neg_union = neg[neg >= 0]
            uniq_rows, rev = np.unique(rows, return_inverse=True)
            hist_slices = [self.ct.hist_rev[offsets[r] : offsets[r + 1]] for r in uniq_rows]
            uniq_news, inv = np.unique(np.concatenate(hist_slices + [pos, neg_union]), return_inverse=True)
            M = bucket_for_open(len(uniq_news), self.UNIQUE_BUCKETS)
            if self.device_store:
                lens = np.minimum(self.store.offsets[uniq_news + 1] - self.store.offsets[uniq_news], self.max_token_len)
                T = bucket_for(int(lens.max()), self.TOKEN_BUCKETS)
                tok_states, tok_mask = self.store.padded_index_batch(uniq_news, T, out_rows=M, max_len=self.max_token_len)
            else:
                tok_states, tok_mask = self.store.gather_padded(uniq_news, max_len=self.max_token_len)
                T = bucket_for(tok_states.shape[1], self.TOKEN_BUCKETS)
                grow = ((0, M - len(uniq_news)), (0, max(0, T - tok_states.shape[1])))
                tok_states = np.pad(tok_states[:, :T], (*grow, (0, 0))).astype(np.float32)
                tok_mask = np.pad(tok_mask[:, :T], grow)
                tok_mask[len(uniq_news) :, 0] = 1.0  # keep pad rows non-degenerate
            hist_lens_b = np.array([len(h) for h in hist_slices], dtype=np.int64)
            cuts = np.cumsum(hist_lens_b)
            total_hist = int(cuts[-1]) if len(cuts) else 0
            pos_rel = inv[total_hist : total_hist + len(pos)]
            if negs is None:
                neg_rel = inv[total_hist + len(pos) :]
            else:
                # Every real negative is in uniq_news, so a sorted search
                # finds its row; the -1 pads stay.
                neg_rel = np.where(neg >= 0, np.searchsorted(uniq_news, np.maximum(neg, 0)), -1)
            L = bucket_for(int(hist_lens_b.max()) if len(hist_lens_b) else 1, self.buckets)
            hist_idx, hist_mask = gather_end_aligned(inv[:total_hist], cuts, hist_lens_b, L, out_rows=B)
            pad = B - (stop - start)
            yield (
                tok_states,
                tok_mask.astype(np.float32),
                hist_idx,
                hist_mask,
                np.pad(rev.astype(np.int32), (0, pad)),
                np.pad(pos_rel.astype(np.int32), (0, pad)),
                (
                    np.pad(neg_rel.astype(np.int32), ((0, pad), (0, 0)), constant_values=-1)
                    if negs is not None
                    else np.pad(neg_rel.astype(np.int32), (0, pad))
                ),
                np.pad(np.ones(stop - start, np.float32), (0, pad)),
            )

    def _host_batches(self) -> Iterator[tuple[float, tuple]]:
        """``(pair count, batch)`` per step, the batch as pinned CPU tensors
        (built on the prefetch thread)."""
        for batch in self._epoch_batches():
            yield float(batch[-1].sum()), _pinned(self._shard(batch), self.device)

    def _loss(self, batch) -> torch.Tensor:
        enc, tower, gen = self.token_encoder, self.tower, self.generator
        infonce = self.cfg.loss == "infonce"
        if self.device_store:
            if infonce:
                return e2e_infonce_loss_gathered(enc, tower, self._dev_states, batch, gen)
            return e2e_margin_loss_gathered(enc, tower, self._dev_states, batch, self.cfg.margin, gen)
        if infonce:
            return e2e_infonce_loss(enc, tower, batch, gen)
        return e2e_margin_loss(enc, tower, batch, self.cfg.margin, gen)

    def train_one_epoch(self) -> float:
        """One epoch of steps; returns the pair-weighted mean loss. The loss
        is fetched every ``loss_sync_every`` steps, and a non-finite one
        raises ``FloatingPointError`` (at most ``loss_sync_every - 1`` steps
        late; every loss is checked at the epoch's end)."""
        sync = max(1, self.cfg.loss_sync_every)
        losses, counts = [], []
        for count, batch in prefetch(self._host_batches()):
            batch = tuple(t.to(self.device, non_blocking=True) for t in batch)
            if self._mesh_step is not None:
                losses.append(self._mesh_step(self.optimizer, self._dev_states, None, batch))
            else:
                losses.append(apply_step(self.optimizer, self._loss(batch)))
            if len(losses) % sync == 0:
                losses[-1] = float(losses[-1])
                if not np.isfinite(losses[-1]):
                    raise FloatingPointError("NaN/Inf loss in end-to-end training")
            counts.append(count)
        losses = [float(x) for x in losses]
        if losses and not np.isfinite(losses).all():
            raise FloatingPointError("NaN/Inf loss in end-to-end training")
        return float(np.dot(losses, counts) / np.sum(counts))

    # ------------------------------------------------------------------
    # Evaluation, epochs, materialization
    # ------------------------------------------------------------------

    def _eval_split(self, compiled: CompiledBehaviors, store: TokenStore) -> dict[str, float]:
        """The split's learned news embeddings materialized from ``store``,
        then the tower's scores and the MIND metrics."""
        emb = torch.from_numpy(self.materialize_news_embeddings(store=store)).to(self.device)
        max_len = self.buckets[-1]
        if self.device_metrics:
            return _fused_eval_metrics(
                self._fused_plans, self.tower, compiled, emb, None, max_len, self.device, mesh=self.mesh
            )
        slots, cand_rows = history_candidate_slots(compiled)
        scores = score_all_impressions(
            self.tower, emb, compiled.hist_rev, compiled.hist_lens, compiled.imp_rev[slots], cand_rows,
            batch_size=self.cfg.batch_size, buckets=self.buckets, flat_tokens=self.flat_eval,
            flat_max_len=max_len, mesh=self.mesh, device=self.device,
        )
        return compose_final_scores(compiled, history_scores=scores).metrics

    def evaluate(self) -> tuple[dict, Optional[dict]]:
        train_scores = self._eval_split(self.ct, self.store)
        val_scores = self._eval_split(self.cv, self.store_val) if self.cv is not None else None
        return train_scores, val_scores

    def train(self, num_epochs: Optional[int] = None) -> list[dict]:
        """``num_epochs`` (default ``cfg.num_epochs``) epochs; numbering
        continues after a restore. Each epoch's record (loss, and with
        ``eval_each_epoch`` both splits' metrics) goes to the history and to
        ``train_final_history_score.jsonl``."""
        num_epochs = num_epochs or self.cfg.num_epochs
        done = len(self.history)
        for epoch in range(done + 1, done + num_epochs + 1):
            record: dict = {"exp_name": self.exp_name, "epoch": epoch, "loss": self.train_one_epoch()}
            val_scores = None
            if self.eval_each_epoch:
                record["train"], val_scores = self.evaluate()
                record["val"] = val_scores
            self.history.append(record)
            _log_jsonl(self.log_dir, f"train_{self.LOG_NAME}_score.jsonl", record)
            if self.best.ckpt_dir is None:
                continue
            path = self.best.ckpt_dir / f"Epoch_{epoch}"
            if val_scores is not None:
                self.best.update(epoch, val_scores, self.model.state_dict())  # writes Epoch_N too
            elif self.best.write:
                self.best.ckpt_dir.mkdir(parents=True, exist_ok=True)
                save_pytree(path, self.model.state_dict())
            if self.remote_sync is not None:
                self.remote_sync(path)
        if self.mesh is not None:
            self.mesh.barrier()  # rank 0's checkpoints are on disk before any rank reads them
        return self.history

    def materialize_news_embeddings(self, batch_size: Optional[int] = None, store: Optional[TokenStore] = None) -> np.ndarray:
        """The learned token encoder over every item of ``store`` (default:
        the train store) -> [N, D] float32 news embeddings
        (``ops.encode.materialize_from_token_store``); the train store reads
        its states on the card when they live there, any other streams from
        the host; on a mesh the train store's resident states (replicated or
        sharded) go through ``materialize_from_token_store_mesh``."""
        target = self.store if store is None else store
        if self.mesh is not None and self.device_store and target is self.store:
            return materialize_from_token_store_mesh(
                self.token_encoder, target, self.mesh, self._dev_states, batch_size=batch_size,
                max_token_len=self.max_token_len, token_buckets=self.TOKEN_BUCKETS, device=self.device,
            )
        return materialize_from_token_store(
            self.token_encoder, target, batch_size=batch_size, max_token_len=self.max_token_len,
            token_buckets=self.TOKEN_BUCKETS, dev_states=self._dev_states if target is self.store else None,
            device=self.device,
        )


# Rows of the flat states copied to the device at a time: bounds the host
# memory an upload holds beside the store (a memmap reads only these).
_UPLOAD_ROWS = 1 << 16


def _upload_states(states: np.ndarray, device: torch.device) -> torch.Tensor:
    """The store's flat states as one tensor on ``device``, in their own
    type, copied in pieces of ``_UPLOAD_ROWS`` rows."""
    out = torch.empty(tuple(states.shape), dtype=torch.from_numpy(np.zeros(0, states.dtype)).dtype, device=device)
    for a in range(0, states.shape[0], _UPLOAD_ROWS):
        out[a : a + _UPLOAD_ROWS] = torch.from_numpy(np.array(states[a : a + _UPLOAD_ROWS]))
    return out
