"""Preset experiment configurations: the five scenarios of
``BASELINE_CONFIGS`` and a runner for each. config[0] is the frozen
mean-pool scorer (no training, the bucketed eval); config[1] a user tower
trained on frozen news embeddings, with epoch evals and the MIND metrics;
config[2] a learned token encoder and the latent tower trained end to end
from frozen per-token states; config[3] config[1] on a mesh of ranks (a
row-sharded table, data-parallel steps, the sharded eval); config[4] the
pipeline over a mesh: a data-parallel encode of the corpus, then config[0]
or config[3] on the table it gives."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from .config import HISTORY_BUCKETS, MeshConfig, TowerConfig, TrainConfig
from .data.compiler import CompiledBehaviors
from .eval.ranker import compose_final_scores, history_candidate_slots
from .device import resolve_device
from .models import TokenAttentionPool, average_pool, build_tower, supports_flat_scoring
from .models.convert import e2e_state_dict_from_jax, random_e2e_params, random_tower_params, tower_state_dict_from_jax
from .ops.encode import TokenStore
from .ops.scoring import score_all_impressions
from .train.trainer import EndToEndTrainer, TowerTrainer, _fused_eval_metrics


@dataclasses.dataclass(frozen=True)
class BaselineScenario:
    index: int
    description: str
    tower: Optional[TowerConfig]
    train: Optional[TrainConfig]
    mesh: Optional[MeshConfig]


BASELINE_CONFIGS: tuple[BaselineScenario, ...] = (
    BaselineScenario(
        0,
        "frozen embeddings + mean-pooled history + dot-product scorer",
        tower=None,
        train=None,
        mesh=None,
    ),
    BaselineScenario(
        1,
        "latent-attention user tower + in-batch (InfoNCE) negatives",
        tower=TowerConfig(kind="latent"),
        train=TrainConfig(num_epochs=5, loss="infonce"),
        mesh=None,
    ),
    BaselineScenario(
        2,
        "end-to-end trained news encoder + latent user tower",
        tower=TowerConfig(kind="latent"),
        train=TrainConfig(num_epochs=5, learning_rate=1e-6),
        mesh=None,
    ),
    BaselineScenario(
        3,
        "row-sharded embedding table, data-parallel towers",
        tower=TowerConfig(kind="latent"),
        train=TrainConfig(num_epochs=5),
        mesh=MeshConfig(model_size=2),
    ),
    BaselineScenario(
        4,
        "multi-host full pipeline: sharded encode -> dump -> on-device ranking",
        tower=TowerConfig(kind="latent"),
        train=TrainConfig(num_epochs=5),
        mesh=MeshConfig(model_size=2),
    ),
)


def run_config0(
    compiled: CompiledBehaviors,
    news_embeddings: np.ndarray,
    query_news_embeddings: Optional[np.ndarray] = None,
    device=None,
) -> dict:
    """Config[0]: no training; each user vector is the mean of its history's
    embeddings (the most recent ``HISTORY_BUCKETS[-1]`` clicks), read from
    ``query_news_embeddings`` (``None``: ``news_embeddings``), candidates
    scored by cosine against ``news_embeddings``, the MIND metrics.
    ``device=None`` means CUDA."""
    slots, cand_rows = history_candidate_slots(compiled)
    view = compiled.with_history_view()
    scores = score_all_impressions(
        average_pool,
        news_embeddings,
        view.hist_rev,
        view.hist_lens,
        compiled.imp_rev[slots],
        cand_rows,
        query_news_emb=query_news_embeddings,
        device=device,
    )
    return compose_final_scores(compiled, history_scores=scores).metrics


def run_config1(
    compiled: CompiledBehaviors,
    news_embeddings: np.ndarray,
    compiled_val: Optional[CompiledBehaviors] = None,
    news_embeddings_val: Optional[np.ndarray] = None,
    train_cfg: Optional[TrainConfig] = None,
    tower_cfg: Optional[TowerConfig] = None,
    device=None,
) -> dict:
    """Config[1]: train the user tower of ``tower_cfg`` (default: the latent
    tower at the table's width), return the last epoch's val (or, without a
    val set, train) metrics. The tower starts from random weights drawn
    from ``train_cfg.seed`` with numpy (``random_tower_params``). The flat
    step and the fused flat eval where the tower is token-local
    (``supports_flat_scoring``), the padded step and the bucketed eval
    otherwise. ``device=None`` means CUDA."""
    tower_cfg = tower_cfg or _sized_tower(news_embeddings.shape[1])
    train_cfg = train_cfg or TrainConfig(num_epochs=2, batch_size=256)
    tower = build_tower(tower_cfg)
    params = random_tower_params(np.random.default_rng(train_cfg.seed), tower_cfg)
    tower.load_state_dict(tower_state_dict_from_jax(tower_cfg.kind, params))
    flat = supports_flat_scoring(tower_cfg)
    trainer = TowerTrainer(
        tower,
        compiled.with_history_view(),
        news_embeddings,
        compiled_val=compiled_val.with_history_view() if compiled_val else None,
        news_emb_val=news_embeddings_val,
        cfg=train_cfg,
        flat_train=flat,
        flat_eval=flat,
        device_metrics=flat,  # epoch evals fetch five scalars
        device=device,
    )
    last = trainer.train()[-1]
    return last["val"] if last["val"] is not None else last["train"]


def run_config3(
    compiled: CompiledBehaviors,
    news_embeddings: np.ndarray,
    compiled_val: Optional[CompiledBehaviors] = None,
    news_embeddings_val: Optional[np.ndarray] = None,
    mesh_cfg: Optional[MeshConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    tower_cfg: Optional[TowerConfig] = None,
    device=None,
) -> dict:
    """Config[3]: config[1] on the mesh of ``mesh_cfg`` (default
    ``MeshConfig(model_size=2)``, built by ``parallel.build_mesh`` over the
    world's ranks, on the process group that torchrun or ``launch``
    started): the table row-sharded over the model
    axis, the padded step data parallel (as the JAX package's config[3]
    trains), and the sharded flat eval with the metrics on the device for a
    token-local tower. Every rank calls it and returns the last epoch's val
    (or train) metrics, equal to a single-device ``TowerTrainer``'s.
    ``device=None`` means CUDA (the rank's card)."""
    from .parallel import build_mesh

    mesh = build_mesh(mesh_cfg or MeshConfig(model_size=2), device=device)
    tower_cfg = tower_cfg or _sized_tower(news_embeddings.shape[1])
    train_cfg = train_cfg or TrainConfig(num_epochs=2, batch_size=256)
    tower = build_tower(tower_cfg)
    params = random_tower_params(np.random.default_rng(train_cfg.seed), tower_cfg)
    tower.load_state_dict(tower_state_dict_from_jax(tower_cfg.kind, params))
    flat = supports_flat_scoring(tower_cfg)
    trainer = TowerTrainer(
        tower,
        compiled.with_history_view(),
        news_embeddings,
        compiled_val=compiled_val.with_history_view() if compiled_val else None,
        news_emb_val=news_embeddings_val,
        cfg=train_cfg,
        mesh=mesh,
        flat_train=False,
        flat_eval=flat,
        device_metrics=flat,  # the sharded eval's only exchange is five sums
        device=device,
    )
    last = trainer.train()[-1]
    return last["val"] if last["val"] is not None else last["train"]


def _sized_tower(dim: int) -> TowerConfig:
    return TowerConfig(
        kind="latent",
        embedding_dim=dim,
        reduced_dim=dim,
        hidden_dim=4 * dim,
        num_latents=min(64, dim),
        latent_dim_head=max(8, dim // 2),
    )


def run_config2(
    compiled: CompiledBehaviors,
    token_store: TokenStore,
    dim: int,
    train_cfg: Optional[TrainConfig] = None,
    max_token_len: int = 64,
    device=None,
) -> dict:
    """Config[2]: a ``TokenAttentionPool`` (one layer at ``dim``) and the
    latent tower (16 latents or ``dim``, heads of ``max(8, dim // 4)``)
    trained end to end from ``token_store``'s frozen per-token states
    (``EndToEndTrainer``, default one epoch at batch 32), the news
    embeddings materialized, then the fused flat eval's MIND metrics over
    ``compiled``. Weights are drawn from ``train_cfg.seed`` with numpy
    (``random_e2e_params``). ``device=None`` means CUDA."""
    device = resolve_device(device)
    train_cfg = train_cfg or TrainConfig(num_epochs=1, batch_size=32)
    tower_cfg = TowerConfig(kind="latent", reduced_dim=dim, num_latents=min(16, dim), latent_dim_head=max(8, dim // 4))
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(hidden_size=dim, num_layers=1), "tower": build_tower(tower_cfg)})
    model.load_state_dict(e2e_state_dict_from_jax(random_e2e_params(np.random.default_rng(train_cfg.seed), dim, 1, tower_cfg)))
    trainer = EndToEndTrainer(
        model["token_encoder"], model["tower"], compiled.with_history_view(), token_store,
        cfg=train_cfg, max_token_len=max_token_len, device=device,
    )
    trainer.train()
    news_emb = torch.from_numpy(trainer.materialize_news_embeddings(batch_size=32)).to(device)
    return _fused_eval_metrics({}, trainer.tower, compiled, news_emb, None, HISTORY_BUCKETS[-1], device)


# Rows a data rank encodes a call in run_config4: bounds the activations of
# an encode of a whole corpus (the JAX package's one call holds them all).
_ENCODE_ROWS = 512


def run_config4(
    compiled: CompiledBehaviors,
    token_ids: np.ndarray,
    token_mask: np.ndarray,
    encoder: torch.nn.Module,
    mesh_cfg: Optional[MeshConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    tower_cfg: Optional[TowerConfig] = None,
    device=None,
) -> dict:
    """Config[4], the pipeline over the mesh of ``mesh_cfg`` (default
    ``MeshConfig(model_size=2)``; every rank calls it alike): the corpus's
    ``[N, T]`` token ids and mask (rows aligned with ``compiled.news_ids``)
    encoded data parallel by ``encoder`` (a ``models.NewsEncoder``;
    ``parallel.sharding.make_sharded_encode_fn``, in chunks of
    ``_ENCODE_ROWS`` rows a data rank, the last padded with rows whose mask
    keeps slot 0), then the table scored by config[0]'s mean-pool ranker
    with ``train_cfg=None``, else trained and evaluated by config[3]. Every
    rank returns the metrics. ``device=None`` means CUDA (the rank's card)."""
    from .parallel import build_mesh
    from .parallel.sharding import make_sharded_encode_fn

    device = resolve_device(device)
    mesh = build_mesh(mesh_cfg or MeshConfig(model_size=2), device=device)
    encode = make_sharded_encode_fn(mesh, encoder.to(device).eval())
    n, chunk = token_ids.shape[0], _ENCODE_ROWS * mesh.data_size
    parts = []
    for start in range(0, n, chunk):
        ids, mask = token_ids[start : start + chunk], np.array(token_mask[start : start + chunk])
        pad = (-len(ids)) % mesh.data_size
        ids = np.pad(ids, ((0, pad), (0, 0)))
        mask = np.pad(mask, ((0, pad), (0, 0)))
        mask[len(mask) - pad :, 0] = 1
        parts.append(encode(ids, mask)[: len(ids) - pad].float().cpu().numpy())
    emb = np.concatenate(parts)
    if train_cfg is None:
        return run_config0(compiled, emb, device=device)
    return run_config3(
        compiled, emb, compiled_val=compiled, news_embeddings_val=emb, mesh_cfg=mesh_cfg, train_cfg=train_cfg,
        tower_cfg=tower_cfg, device=device,
    )
