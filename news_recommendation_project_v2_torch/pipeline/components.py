"""The pipeline's components, over one vocabulary of context keys:

- ``"compiled"``: ``CompiledBehaviors`` (from ``TransformDataComponent``);
- ``"news_embeddings"`` / ``"query_news_embeddings"``: [N, D] float32 numpy
  tables aligned to ``compiled.news_ids`` (passages; e5's query side, which
  the user towers read the histories from);
- ``"classification_preds"``: the content scorer's score per unique news;
- ``"scores"`` / ``"grouped_ranks"`` / ``"metrics"``: the final outputs;
- ``"token_store"``: a ``TokenStore`` of frozen per-token states.

Every component that runs a model takes ``device`` (``None``: CUDA) and
keeps its modules there; the context holds host arrays only. Modules start
from weights drawn with numpy from ``cfg.seed`` (``models.convert``'s
``random_*_params``), or from a ``warm_start`` state dict.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import HISTORY_BUCKETS, TowerConfig, TrainConfig
from ..data.compiler import CompiledBehaviors, compile_behaviors
from ..device import resolve_device
from ..eval.ranker import compose_final_scores, history_candidate_slots
from ..models import (
    ClassificationHead,
    ReducingModel,
    WeightedSumModel,
    build_tower,
    check_tower_input_dim,
    convert,
    supports_flat_scoring,
)
from ..ops.encode import load_embeddings, save_embeddings
from ..ops.scoring import score_all_impressions
from ..train.checkpoint import load_pytree
from ..train.trainer import ClassificationTrainer, EndToEndTrainer, JointTowerTrainer, TowerTrainer
from .pipeline import PipelineComponent


def _with_results(context: dict, compiled: CompiledBehaviors, **kwargs) -> dict:
    """``scores``, ``grouped_ranks`` and (with labels) ``metrics`` from
    ``eval.ranker.compose_final_scores(compiled, **kwargs)``."""
    res = compose_final_scores(compiled, compute_metrics=compiled.label_present, **kwargs)
    context["scores"] = res.scores
    context["grouped_ranks"] = res.grouped_ranks
    context["metrics"] = res.metrics
    return context


class TransformDataComponent(PipelineComponent):
    """The behaviors rows (``data.ingest.Behaviors``) -> ``compiled`` and
    ``imp_ids``; the rows leave the context. Where the per-news feature
    dicts of ``data.ingest.load_dataset`` are present, they become arrays
    aligned to ``compiled.news_ids``: category and subcategory ids (0 where
    unknown) and the mean title and abstract entity vectors."""

    required_keys = {"behaviors"}

    def transform(self, context: dict[str, Any]) -> dict[str, Any]:
        behaviors = context.pop("behaviors")
        compiled = compile_behaviors(behaviors["Impressions"].tolist(), behaviors["History"].tolist())
        context["compiled"] = compiled
        context["imp_ids"] = np.asarray(behaviors["ImpressionID"])
        for key in ("news_category", "news_subcategory"):
            if key in context:
                lut = context.pop(key)
                context[key + "_ids"] = np.array(
                    [v if (v := lut.get(n)) is not None else 0 for n in compiled.news_ids], dtype=np.int32
                )
        for key in ("news_title_entity", "news_abstract_entity"):
            if key in context:
                lut = context.pop(key)
                zero = np.zeros_like(next(iter(lut.values())))
                context[key + "_vecs"] = np.stack(
                    [np.asarray(lut.get(n, zero)) for n in compiled.news_ids]
                ).astype(np.float32)
        return context


class EmbeddingsComponent(PipelineComponent):
    """The news texts of ``compiled.news_ids`` through the encoder, as its
    two tables: ``news_embeddings`` (the passage side, the raw text) and
    ``query_news_embeddings`` (``query_instruction`` + text; NV-Embed pools
    without the instruction), by ``ops.encode.encode_query_and_passage``.
    ``batch_size=None`` takes the memory model's batch; ``token_buckets``
    runs each text at the narrowest bucket that holds it (``None``: the
    tokenizer's full width)."""

    required_keys = {"compiled", "news_text_dict"}
    cacheable = False  # the encoder's weights live outside the context

    def __init__(
        self,
        encoder: torch.nn.Module,
        tokenize: Callable,
        query_instruction: str,
        batch_size: Optional[int] = 256,
        token_buckets: Optional[tuple[int, ...]] = (32, 64, 128, 256, 512),
        device=None,
    ):
        self.encoder = encoder
        self.tokenize = tokenize
        self.query_instruction = query_instruction
        self.batch_size = batch_size
        self.token_buckets = token_buckets
        self.device = resolve_device(device)

    def transform(self, context):
        from ..ops.encode import encode_query_and_passage

        compiled: CompiledBehaviors = context["compiled"]
        texts = [context["news_text_dict"][n] for n in compiled.news_ids]
        query, passage = encode_query_and_passage(
            self.encoder,
            self.tokenize,
            texts,
            self.query_instruction,
            self.batch_size,
            buckets=self.token_buckets,
            device=self.device,
        )
        context["news_embeddings"] = passage.cpu().numpy()
        context["query_news_embeddings"] = query.cpu().numpy()
        return context


@dataclasses.dataclass
class SaveEmbeddingComponent(PipelineComponent):
    """Writes the id-keyed dump (``ops.encode.save_embeddings``): the
    passage table, the query table where the context has one, and the news
    ids."""

    save_dir: Path
    dataset_name: str
    required_keys = {"news_embeddings", "compiled"}

    def transform(self, context):
        save_embeddings(
            self.save_dir,
            self.dataset_name,
            context["news_embeddings"],
            context.get("query_news_embeddings"),
            news_ids=context["compiled"].news_ids,
        )
        return context


@dataclasses.dataclass
class LoadEmbeddingComponent(PipelineComponent):
    """Reads a dump into the context, its rows realigned by id to this
    run's ``compiled.news_ids``, so the dump's rows need not be this run's
    (``load_embeddings(align_to_news_ids=)``); with ``with_query`` the
    query table too."""

    save_dir: Path
    dataset_name: str
    with_query: bool = True
    required_keys = {"compiled"}

    def transform(self, context):
        align = context["compiled"].news_ids
        if self.with_query:
            emb, query = load_embeddings(self.save_dir, self.dataset_name, with_query=True, align_to_news_ids=align)
            context["news_embeddings"] = emb
            context["query_news_embeddings"] = query
        else:
            context["news_embeddings"] = load_embeddings(self.save_dir, self.dataset_name, align_to_news_ids=align)
        return context


class ClassificationComponent(PipelineComponent):
    """The content-only scorer: ``train`` fits a ``ClassificationHead``
    (``ClassificationTrainer``) and reloads its best checkpoint; ``transform``
    writes ``classification_preds`` and the scores of every candidate by the
    head alone."""

    required_keys = {"compiled", "news_embeddings"}

    def __init__(
        self,
        cfg: TrainConfig = TrainConfig(),
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "classification",
        warm_start: Optional[Path] = None,
        mesh=None,
        device=None,
    ):
        self.cfg = cfg
        self.log_dir = log_dir
        self.ckpt_dir = ckpt_dir
        self.exp_name = exp_name
        self.warm_start = warm_start
        self.mesh = mesh
        self.device = resolve_device(device)
        self._trainer: Optional[ClassificationTrainer] = None

    def cache_token(self) -> str:
        return f"{self.cfg}|{self.exp_name}|{self.warm_start}"

    def _head(self, dim: int) -> ClassificationHead:
        """A ``ClassificationHead(dim, dim)``: weights drawn from
        ``cfg.seed``, or the ``warm_start`` state dict."""
        head = ClassificationHead(in_dim=dim, hidden_dim=dim)
        params = convert.random_classification_head_params(np.random.default_rng(self.cfg.seed), dim, dim)
        head.load_state_dict(convert.classification_head_state_dict_from_jax(params))
        if self.warm_start:
            head.load_state_dict(load_pytree(self.warm_start))
        return head

    def train(self, context, val_context=None):
        emb = context["news_embeddings"]
        self._trainer = ClassificationTrainer(
            self._head(emb.shape[1]),
            context["compiled"],
            emb,
            compiled_val=val_context["compiled"] if val_context else None,
            news_emb_val=val_context["news_embeddings"] if val_context else None,
            cfg=self.cfg,
            log_dir=self.log_dir,
            ckpt_dir=self.ckpt_dir,
            exp_name=self.exp_name,
            mesh=self.mesh,
            device=self.device,
        )
        self._trainer.train()
        if self._trainer.best.best_path is not None:
            self._trainer.head.load_state_dict(load_pytree(self._trainer.best.best_path))

    def transform(self, context):
        emb = context["news_embeddings"]
        if self._trainer is None:
            self._trainer = ClassificationTrainer(
                self._head(emb.shape[1]), context["compiled"], emb, cfg=self.cfg, device=self.device
            )
        preds = self._trainer.baseline_scores(emb)
        context["classification_preds"] = preds
        return _with_results(context, context["compiled"], baseline_scores=preds)


class _TowerComponentBase(PipelineComponent):
    """A user tower of ``tower_config`` on ``device``: weights drawn from
    ``cfg.seed`` on first use (``_init_params``), or the ``warm_start``
    state dict (a ``Best_model_*`` or ``Epoch_N`` of the trainers)."""

    required_keys = {"compiled", "news_embeddings"}

    def __init__(
        self,
        tower_config: TowerConfig = TowerConfig(),
        cfg: TrainConfig = TrainConfig(),
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "attention",
        warm_start: Optional[Path] = None,
        buckets: Optional[tuple[int, ...]] = None,
        mesh=None,
        device=None,
    ):
        self.tower_config = tower_config
        self.cfg = cfg
        self.log_dir = log_dir
        self.ckpt_dir = ckpt_dir
        self.exp_name = exp_name
        self.warm_start = warm_start
        self.buckets = buckets
        self.mesh = mesh
        self.device = resolve_device(device)
        self.tower = build_tower(tower_config)
        self.initialised = False

    def cache_token(self) -> str:
        return f"{self.tower_config}|{self.cfg}|{self.exp_name}|{self.warm_start}"

    def _init_params(self, dim: int) -> torch.nn.Module:
        check_tower_input_dim(self.tower_config, dim)
        if not self.initialised:
            params = convert.random_tower_params(np.random.default_rng(self.cfg.seed), self.tower_config)
            self.tower.load_state_dict(convert.tower_state_dict_from_jax(self.tower_config.kind, params))
            if self.warm_start:
                self.tower.load_state_dict(load_pytree(self.warm_start))
            self.tower.to(self.device)
            self.initialised = True
        return self.tower

    def _flat(self) -> bool:
        """Token-local towers take the flat step and eval; explicit
        ``buckets`` force the padded path everywhere (train, eval and
        transform share one truncation)."""
        return supports_flat_scoring(self.tower_config) and self.buckets is None

    def _bucket_kwargs(self) -> dict:
        return {} if self.buckets is None else {"buckets": self.buckets}

    def _history_scores(self, context) -> np.ndarray:
        """The tower's cosine scores of every with-history candidate slot,
        the histories read from ``query_news_embeddings`` where the context
        has it."""
        compiled: CompiledBehaviors = context["compiled"]
        view = compiled.with_history_view()
        slots, cand_rows = history_candidate_slots(compiled)
        kwargs = self._bucket_kwargs()
        if self._flat():
            kwargs.update(flat_tokens=True, flat_max_len=HISTORY_BUCKETS[-1])  # the padded path's cap
        return score_all_impressions(
            self.tower,
            context["news_embeddings"],
            view.hist_rev,
            view.hist_lens,
            compiled.imp_rev[slots],
            cand_rows,
            query_news_emb=context.get("query_news_embeddings"),
            batch_size=self.cfg.batch_size,
            device=self.device,
            **kwargs,
        )


class AttentionComponent(_TowerComponentBase):
    """The user tower trained alone (``TowerTrainer``; the flat step for a
    token-local tower under the margin loss, the flat eval with the metrics
    on the device for a token-local tower), its best checkpoint reloaded;
    ``transform`` scores the with-history rows by the tower over the
    content baseline of the rows without (``classification_preds``)."""

    def train(self, context, val_context=None):
        compiled: CompiledBehaviors = context["compiled"]
        emb = context["news_embeddings"]
        self._init_params(emb.shape[1])
        flat = self._flat()
        trainer = TowerTrainer(
            self.tower,
            compiled.with_history_view(),
            emb,
            compiled_val=val_context["compiled"].with_history_view() if val_context else None,
            news_emb_val=val_context["news_embeddings"] if val_context else None,
            cfg=self.cfg,
            query_news_emb_train=context.get("query_news_embeddings"),
            query_news_emb_val=val_context.get("query_news_embeddings") if val_context else None,
            log_dir=self.log_dir,
            ckpt_dir=self.ckpt_dir,
            exp_name=self.exp_name,
            flat_train=flat and self.cfg.loss == "margin",
            flat_eval=flat,
            device_metrics=flat,  # epoch evals fetch five scalars
            mesh=self.mesh,
            device=self.device,
            **self._bucket_kwargs(),
        )
        trainer.train()
        if trainer.best.best_path is not None:
            self.tower.load_state_dict(load_pytree(trainer.best.best_path))

    def transform(self, context):
        self._init_params(context["news_embeddings"].shape[1])
        return _with_results(
            context,
            context["compiled"],
            history_scores=self._history_scores(context),
            baseline_scores=context.get("classification_preds"),
        )


class FinalAttentionComponent(AttentionComponent):
    """The tower's scores with no content fallback: for with-history rows
    (``DataSubset.WITH_HISTORY``), as the eval CLI loads them."""

    def transform(self, context):
        self._init_params(context["news_embeddings"].shape[1])
        return _with_results(context, context["compiled"], history_scores=self._history_scores(context))


class AttentionWeightComponent(_TowerComponentBase):
    """The tower trained jointly with a ``WeightedSumModel`` blend of its
    cosine and the content baseline (``JointTowerTrainer``); ``transform``
    blends by the trained weight (0.5 before training)."""

    required_keys = {"compiled", "news_embeddings", "classification_preds"}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.blend = WeightedSumModel()  # alpha starts at 0
        self._trainer: Optional[JointTowerTrainer] = None

    def train(self, context, val_context=None):
        emb = context["news_embeddings"]
        self._init_params(emb.shape[1])
        flat = self._flat()
        self._trainer = JointTowerTrainer(
            self.tower,
            context["compiled"].with_history_view(),
            emb,
            blend=self.blend,
            baseline_train=context["classification_preds"],
            baseline_val=val_context.get("classification_preds") if val_context else None,
            compiled_val=val_context["compiled"].with_history_view() if val_context else None,
            news_emb_val=val_context["news_embeddings"] if val_context else None,
            cfg=self.cfg,
            query_news_emb_train=context.get("query_news_embeddings"),
            log_dir=self.log_dir,
            ckpt_dir=self.ckpt_dir,
            exp_name=self.exp_name,
            flat_eval=flat,
            device_metrics=flat,
            mesh=self.mesh,
            device=self.device,
        )
        self._trainer.train()

    def transform(self, context):
        self._init_params(context["news_embeddings"].shape[1])
        alpha = 0.5 if self._trainer is None else self._trainer._alpha()
        return _with_results(
            context,
            context["compiled"],
            history_scores=self._history_scores(context),
            baseline_scores=context["classification_preds"],
            alpha=alpha,
        )


class AttentionReduceComponent(_TowerComponentBase):
    """The tower trained jointly with a ``ReducingModel`` projector to
    ``reduced_dim`` (default: the table's width) under one optimizer
    (``JointTowerTrainer``); ``transform`` scores the reduced table (its
    query table is not used), over the content baseline. The projector's
    weights are drawn from ``cfg.seed + 2``."""

    def __init__(self, *args, reduced_dim: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.reduced_dim = reduced_dim
        self.reducer: Optional[ReducingModel] = None
        self._trainer: Optional[JointTowerTrainer] = None

    def train(self, context, val_context=None):
        emb = context["news_embeddings"]
        dim = emb.shape[1]
        out_dim = self.reduced_dim or dim
        self.reducer = ReducingModel(input_dim=dim, output_dim=out_dim)
        params = convert.random_reducing_params(np.random.default_rng(self.cfg.seed + 2), dim, out_dim)
        self.reducer.load_state_dict(convert.reducing_state_dict_from_jax(params))
        self._init_params(out_dim)
        self._trainer = JointTowerTrainer(
            self.tower,
            context["compiled"].with_history_view(),
            emb,
            reduce=self.reducer,
            compiled_val=val_context["compiled"].with_history_view() if val_context else None,
            news_emb_val=val_context["news_embeddings"] if val_context else None,
            cfg=self.cfg,
            log_dir=self.log_dir,
            ckpt_dir=self.ckpt_dir,
            exp_name=self.exp_name,
            flat_eval=False,
            mesh=self.mesh,
            device=self.device,
        )
        self._trainer.train()

    def transform(self, context):
        assert self._trainer is not None, "AttentionReduceComponent needs train()"
        with torch.no_grad():
            reduced = self.reducer(torch.as_tensor(context["news_embeddings"], device=self.device))
        reduce_ctx = {k: v for k, v in context.items() if k != "query_news_embeddings"}
        reduce_ctx["news_embeddings"] = reduced.float().cpu().numpy()
        return _with_results(
            context,
            context["compiled"],
            history_scores=self._history_scores(reduce_ctx),
            baseline_scores=context.get("classification_preds"),
        )


@dataclasses.dataclass
class StoreTokenStatesComponent(PipelineComponent):
    """The news texts through the frozen encoder without its pool: their
    mask-trimmed per-token states as ``token_store``
    (``ops.encode.build_token_store``; with ``db_path`` written to that
    directory in the ``TokenStore`` directory format and opened from disk).
    The texts leave the context."""

    encoder: torch.nn.Module
    tokenize: Callable
    db_path: Optional[Path] = None
    batch_size: int = 64
    device: Any = None
    required_keys = {"compiled", "news_text_dict"}
    cacheable = False

    def transform(self, context):
        from ..ops.encode import build_token_store

        compiled: CompiledBehaviors = context["compiled"]
        texts = [context["news_text_dict"][n] for n in compiled.news_ids]
        ids, mask = self.tokenize(texts)
        context["token_store"] = build_token_store(
            self.encoder, ids, mask, self.batch_size, out_dir=self.db_path, device=resolve_device(self.device)
        )
        context.pop("news_text_dict", None)
        return context


class AttentionAttentionComponent(PipelineComponent):
    """The end-to-end component (config[2]): ``train`` fits the token
    encoder and the tower together from ``token_store``
    (``EndToEndTrainer``); ``transform`` writes the learned news embeddings
    (nothing before training)."""

    required_keys = {"compiled", "token_store"}
    cacheable = False

    def __init__(
        self,
        token_encoder: torch.nn.Module,
        tower: torch.nn.Module,
        cfg: TrainConfig = TrainConfig(),
        log_dir: Optional[Path] = None,
        ckpt_dir: Optional[Path] = None,
        exp_name: str = "attn_attn",
        max_token_len: int = 512,
        device=None,
    ):
        self.token_encoder = token_encoder
        self.tower = tower
        self.cfg = cfg
        self.log_dir = log_dir
        self.ckpt_dir = ckpt_dir
        self.exp_name = exp_name
        self.max_token_len = max_token_len
        self.device = resolve_device(device)
        self._trainer: Optional[EndToEndTrainer] = None

    def train(self, context, val_context=None):
        self._trainer = EndToEndTrainer(
            self.token_encoder,
            self.tower,
            context["compiled"].with_history_view(),
            context["token_store"],
            cfg=self.cfg,
            log_dir=self.log_dir,
            ckpt_dir=self.ckpt_dir,
            exp_name=self.exp_name,
            max_token_len=self.max_token_len,
            device=self.device,
        )
        self._trainer.train()

    def transform(self, context):
        if self._trainer is not None:
            context["news_embeddings"] = self._trainer.materialize_news_embeddings()
        return context


@dataclasses.dataclass
class TokenEmbeddingsComponent(PipelineComponent):
    """A learned news-embedding table from ``token_store`` and a trained
    token encoder (``ops.encode.materialize_from_token_store``;
    ``batch_size=None``: the memory model's)."""

    token_encoder: torch.nn.Module
    batch_size: Optional[int] = None
    max_token_len: int = 512
    device: Any = None
    required_keys = {"token_store"}
    cacheable = False

    def transform(self, context):
        from ..ops.encode import materialize_from_token_store

        device = resolve_device(self.device)
        context["news_embeddings"] = materialize_from_token_store(
            self.token_encoder.to(device),
            context["token_store"],
            batch_size=self.batch_size,
            max_token_len=self.max_token_len,
            device=device,
        )
        return context
