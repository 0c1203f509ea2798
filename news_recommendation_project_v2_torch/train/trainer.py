"""Training engine for the latent tower: flat-token train steps over
per-epoch resampled pairs, an epoch eval with the MIND metrics through the
flat eval, JSONL logs, best-checkpoint tracking, a plateau scheduler, and
save and restore of the whole training state.

The port of the JAX package's ``TowerTrainer`` path with ``flat_train=True``
and ``flat_eval=True``: the host samples each epoch's pairs
(``data.sampling``) and builds flat-token batches on a prefetch thread; the
step (``train.step``) runs the tower per token through both hand-written
kernels and their ``autograd.Function``s on CUDA; the epoch eval is the
flat eval (``ops.scoring.FlatEvalPlan``, with ``device_metrics`` its fused
``metrics`` call, five scalars fetched).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` as the JAX
package builds it (``ClippedAdamW``).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import HISTORY_BUCKETS, TrainConfig
from ..data.compiler import CompiledBehaviors
from ..data.grouping import lengths_to_offsets
from ..data.prefetch import prefetch
from ..data.sampling import neg_batch_column, sample_epoch_pairs
from ..device import resolve_device
from ..eval.device_metrics import DeviceMetricsPlan
from ..eval.ranker import compose_final_scores, history_candidate_slots
from ..ops.scoring import FlatEvalPlan, _auto_flat_chunk, score_all_impressions_flat
from .checkpoint import BestTracker, load_pytree, mean_metric, save_pytree
from .step import flat_infonce_step, flat_margin_step


class ClippedAdamW(torch.optim.AdamW):
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(...))``: the
    gradients are scaled by ``max_norm / norm`` only where their global norm
    exceeds ``max_norm`` (``clip_grad_norm_`` would divide by
    ``norm + 1e-6`` always), then AdamW with decoupled weight decay on every
    parameter, as optax's ``adamw`` has no mask. The scale is chosen on the
    device: no host sync."""

    def __init__(self, params, lr: float, weight_decay: float, max_norm: float):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"] if p.grad is not None]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            for g in grads:
                g.mul_(scale)
        return super().step(closure)


def make_optimizer(cfg: TrainConfig, params) -> ClippedAdamW:
    return ClippedAdamW(
        params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay, max_norm=cfg.grad_clip_norm
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
    max_len: int,
    device: torch.device,
) -> dict[str, float]:
    """Epoch eval through ``FlatEvalPlan.metrics``: the tower, the cosine, the
    score composition and the MIND metrics on one device, five scalars
    fetched. The plans (index grids, metric grids) are built once per
    compiled set and cached in ``plan_cache``. Equal to
    ``score_all_impressions_flat`` + ``compose_final_scores(...).metrics``."""
    plans = plan_cache.get(id(compiled))
    if plans is None:
        slots, cand_rows = history_candidate_slots(compiled)
        tokens = int(np.minimum(compiled.hist_lens, max_len).sum())
        fplan = FlatEvalPlan(
            compiled.hist_rev,
            compiled.hist_lens,
            compiled.imp_rev[slots],
            cand_rows,
            chunk_tokens=_auto_flat_chunk(tower.dim, tokens, device),
            max_len=max_len,
            device=device,
        )
        mplan = DeviceMetricsPlan(compiled.imp_lens, compiled.labels_flat, hist_slots=slots, device=device)
        plans = plan_cache[id(compiled)] = (fplan, mplan)
    fplan, mplan = plans
    return fplan.metrics(tower, news_emb, mplan)


class ResumableTrainer:
    """Save and restore of the whole training state, so a resumed run
    continues the original one: the tower's parameters, the optimizer's
    state (moments, step counts, learning rate), the epoch count, the best
    checkpoint's score, the plateau scheduler, and in a JSON sidecar the
    epoch history and the numpy bit generator's state (the epoch sampling
    stream). The tower has no dropout, so no other random stream exists."""

    def save_training_state(self, path: Path) -> None:
        path = Path(path)
        state = {
            "params": self.tower.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "epochs_done": len(self.history),
            "best_score": float(self.best.best_score),
            "plateau_lr": self.plateau.lr,
            "plateau_best": float(self.plateau.best),
            "plateau_stale": self.plateau.stale,
        }
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
        self.tower.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.plateau.lr = float(state["plateau_lr"])
        self.plateau.best = float(state["plateau_best"])
        self.plateau.stale = int(state["plateau_stale"])
        self.best.best_score = float(state["best_score"])
        with open(f"{path}_meta.json") as f:
            meta = json.load(f)
        self.history = list(meta["history"])
        self.rng.bit_generator.state = meta["rng_state"]
        return int(state["epochs_done"])


class TowerTrainer(ResumableTrainer):
    """Trains the latent user tower with pairwise margin ranking or InfoNCE
    over each epoch's sampled impression pairs, by the flat-token step.

    ``compiled_train`` and ``compiled_val`` must be with-history views
    (``CompiledBehaviors.with_history_view``). The tables are numpy arrays or
    tensors, ``[num_news, D]`` float32. ``device=None`` means CUDA
    (``device.resolve_device``): without CUDA it raises, and
    ``device="cpu"`` runs the kernels' plain versions. The history tokens
    are looked up in the same tables as the candidates.

    Not ported yet: the padded step and eval (``flat_train=False`` or
    ``flat_eval=False``) and ``mesh=``, which raise ``NotImplementedError``.
    """

    def __init__(
        self,
        tower: torch.nn.Module,
        compiled_train: CompiledBehaviors,
        news_emb_train,
        compiled_val: Optional[CompiledBehaviors] = None,
        news_emb_val=None,
        cfg: TrainConfig = TrainConfig(),
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
        if mesh is not None:
            raise NotImplementedError("mesh= (multi-GPU training) is not ported yet (ROADMAP.md §1)")
        if not (flat_train and flat_eval):
            raise NotImplementedError(
                "only the flat-token step and eval are ported (flat_train=True, flat_eval=True); "
                "the padded path waits (ROADMAP.md §1, 'The other towers and the padded path')"
            )
        if len(compiled_train.hist_lens) != compiled_train.num_rows:
            raise ValueError("TowerTrainer needs a with-history view (every row must have history)")
        if cfg.loss not in ("margin", "infonce"):
            raise ValueError(f"loss {cfg.loss!r}: want 'margin' or 'infonce'")
        self.device = resolve_device(device)
        self.tower = tower.to(self.device)
        self.cfg = cfg
        self.ct = compiled_train
        self.cv = compiled_val
        self.news_emb_train = self._table(news_emb_train)
        self.news_emb_val = self._table(news_emb_val)
        self.log_dir = log_dir
        self.exp_name = exp_name
        self.buckets = buckets
        self.rng = np.random.default_rng(cfg.seed)
        self.optimizer = make_optimizer(cfg, self.tower.parameters())
        self.best = BestTracker(ckpt_dir, exp_name)
        self.plateau = PlateauScheduler(cfg)
        self.history: list[dict] = []
        self._hist_offsets = lengths_to_offsets(compiled_train.hist_lens)
        self.device_metrics = device_metrics
        self._fused_plans: dict = {}

    def _table(self, emb) -> Optional[torch.Tensor]:
        return None if emb is None else torch.as_tensor(emb, device=self.device)

    # ------------------------------------------------------------------
    # Host input pipeline
    # ------------------------------------------------------------------

    def _epoch_batches_flat(self) -> Iterator[tuple]:
        """One epoch's batches as numpy arrays: each batch's deduped rows'
        flat token stream (the most recent ``buckets[-1]`` clicks of a row),
        padded to the next power of two of at least 1,024 tokens, with the
        pairs padded to ``batch_size``. Equal to the JAX package's, array for
        array, from the same generator state."""
        cfg = self.cfg
        cap = self.buckets[-1]
        offsets = self._hist_offsets
        pairs, negs = sample_epoch_pairs(
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
        B = cfg.batch_size
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

    def _host_batches(self) -> Iterator[tuple]:
        """``_epoch_batches_flat`` as CPU tensors, pinned for CUDA so that
        their copies to the card are asynchronous (no host wait)."""
        pin = self.device.type == "cuda"
        for batch in self._epoch_batches_flat():
            tensors = tuple(torch.from_numpy(a) for a in batch)
            yield tuple(t.pin_memory() for t in tensors) if pin else tensors

    def _train_step(self, batch) -> torch.Tensor:
        cfg = self.cfg
        args = (self.tower, self.optimizer, self.news_emb_train, batch)
        if cfg.loss == "infonce":
            return flat_infonce_step(*args)
        return flat_margin_step(*args, cfg.margin)

    def train_one_epoch(self) -> float:
        """One epoch of steps; returns the pair-weighted mean loss. The loss
        is fetched every ``loss_sync_every`` steps (each fetch waits for the
        card) and every step's loss is recorded."""
        sync = max(1, self.cfg.loss_sync_every)
        losses, counts = [], []
        for batch in prefetch(self._host_batches()):
            loss = self._train_step(tuple(t.to(self.device, non_blocking=True) for t in batch))
            losses.append(loss)
            if len(losses) % sync == 0:
                losses[-1] = float(losses[-1])
            counts.append(float(batch[-1].sum()))
        losses = [float(x) for x in losses]
        return float(np.dot(losses, counts) / np.sum(counts))

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _eval_split(self, compiled: CompiledBehaviors, news_emb) -> dict[str, float]:
        max_len = self.buckets[-1]  # the train step's cap, so both see the same histories
        if self.device_metrics:
            return _fused_eval_metrics(
                self._fused_plans, self.tower, compiled, news_emb, max_len, self.device
            )
        slots, cand_rows = history_candidate_slots(compiled)
        tokens = int(np.minimum(compiled.hist_lens, max_len).sum())
        scores = score_all_impressions_flat(
            self.tower,
            news_emb,
            compiled.hist_rev,
            compiled.hist_lens,
            compiled.imp_rev[slots],
            cand_rows,
            chunk_tokens=_auto_flat_chunk(self.tower.dim, tokens, self.device),
            max_len=max_len,
            device=self.device,
        )
        return compose_final_scores(compiled, history_scores=scores).metrics

    def evaluate(self) -> tuple[dict, Optional[dict]]:
        train_scores = self._eval_split(self.ct, self.news_emb_train)
        val_scores = self._eval_split(self.cv, self.news_emb_val) if self.cv is not None else None
        return train_scores, val_scores

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
                "train_final_history_score.jsonl",
                {"exp_name": self.exp_name, "epoch": epoch, "scores": train_scores, "loss": loss},
            )
            if val_scores is not None:
                _log_jsonl(
                    self.log_dir,
                    "eval_final_history_score.jsonl",
                    {"exp_name": self.exp_name, "epoch": epoch, "scores": val_scores},
                )
                self.best.update(epoch, val_scores, self.tower.state_dict())
                self.plateau.update(self.optimizer, mean_metric(val_scores))
        return self.history
