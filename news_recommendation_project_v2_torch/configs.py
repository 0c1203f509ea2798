"""Preset experiment configurations. This slice ports config[1]: the latent
user tower trained on frozen news embeddings, the flat-token step, and
epoch evals with the MIND metrics computed on the device. The other presets
(the frozen mean-pool scorer, end-to-end encoder training, the multi-GPU
configurations) wait for their modules (ROADMAP.md §1)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import TowerConfig, TrainConfig
from .data.compiler import CompiledBehaviors
from .models import build_tower
from .models.convert import latent_state_dict_from_jax, random_latent_params
from .train.trainer import TowerTrainer


def run_config1(
    compiled: CompiledBehaviors,
    news_embeddings: np.ndarray,
    compiled_val: Optional[CompiledBehaviors] = None,
    news_embeddings_val: Optional[np.ndarray] = None,
    train_cfg: Optional[TrainConfig] = None,
    tower_cfg: Optional[TowerConfig] = None,
    device=None,
) -> dict:
    """Config[1]: train the latent tower, return the last epoch's val (or,
    without a val set, train) metrics. The tower starts from random weights
    drawn from ``train_cfg.seed`` with numpy (``random_latent_params``).
    ``device=None`` means CUDA."""
    tower_cfg = tower_cfg or _sized_tower(news_embeddings.shape[1])
    train_cfg = train_cfg or TrainConfig(num_epochs=2, batch_size=256)
    tower = build_tower(tower_cfg)
    params = random_latent_params(np.random.default_rng(train_cfg.seed), tower_cfg)
    tower.load_state_dict(latent_state_dict_from_jax(params))
    trainer = TowerTrainer(
        tower,
        compiled.with_history_view(),
        news_embeddings,
        compiled_val=compiled_val.with_history_view() if compiled_val else None,
        news_emb_val=news_embeddings_val,
        cfg=train_cfg,
        device_metrics=True,  # epoch evals fetch five scalars
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
