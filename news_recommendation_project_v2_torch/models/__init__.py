"""User towers, the content scorer, the blender and reducer, and pooling,
keyed by ``TowerConfig``."""

from __future__ import annotations

import torch
from torch import nn

from ..config import TowerConfig
from .attention import (
    GatedMLP,
    SelfAttention,
    TokenAttentionPool,
    TransformerEncoder,
    TransformerLayer,
    TransformerTower,
)
from .latent_attention import CrossAttention, GEGLUFeedForward, LatentAttentionTower
from .pooling import POOLING, average_pool, first_token_pool, last_token_pool, pooling_for_architecture
from .towers import (
    ClassificationHead,
    ClassificationHeadCatEmbed,
    EmbeddingWrapper,
    FinalAttention,
    ReducingModel,
    ResizeWrapperModel,
    WeightedSumModel,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
TOWERS = {"final_attention": FinalAttention, "transformer": TransformerTower, "latent": LatentAttentionTower}


def build_tower(config: TowerConfig) -> nn.Module:
    """The user tower of ``config.kind`` (``final_attention``,
    ``transformer`` or ``latent``), its parameters in ``config.param_dtype``
    and its matmuls in ``config.compute_dtype`` (LayerNorms, softmaxes and
    the pool or readout stay float32)."""
    compute = DTYPES[config.compute_dtype]
    if config.kind == "final_attention":
        tower = FinalAttention(
            reduced_dim=config.reduced_dim,
            hidden_dim=config.hidden_dim,
            dropout_rate=config.dropout_rate,
            compute_dtype=compute,
        )
    elif config.kind == "transformer":
        tower = TransformerTower(
            hidden_size=config.reduced_dim,
            num_layers=config.num_layers,
            dropout_rate=config.dropout_rate,
            as_built=config.as_built,
            compute_dtype=compute,
        )
    elif config.kind == "latent":
        tower = LatentAttentionTower(
            dim=config.reduced_dim,
            num_latents=config.num_latents,
            heads=config.num_heads,
            dim_head=config.latent_dim_head,
            compute_dtype=compute,
        )
    else:
        raise ValueError(f"Unknown tower kind: {config.kind!r}")
    return tower.to(DTYPES[config.param_dtype])


def check_tower_input_dim(
    config: TowerConfig, dim: int, flag_hint: str = "--dim"
) -> None:
    """The news-embedding width must equal ``reduced_dim``: the latent and
    transformer towers are residual in their input, and every tower's user
    vector is cosine-scored against the D-wide news embeddings."""
    if dim != config.reduced_dim:
        raise ValueError(
            f"news embeddings are {dim}-dim but the {config.kind} tower is "
            f"configured with reduced_dim={config.reduced_dim}; these must "
            f"match. Pass {flag_hint} {dim} on the CLI (or "
            f"TowerConfig(reduced_dim={dim})) so training, eval, and serving "
            "all restore the same geometry."
        )


def supports_flat_scoring(config: TowerConfig) -> bool:
    """True when every history token's hidden state depends only on that
    token up to the final pool (the tower class's ``token_local``; the latent
    tower: each token attends to the shared latents), so the tower can run
    over the flat token stream. ``final_attention`` normalises its weights
    over the history axis and ``transformer`` attends across it: both take
    the padded path."""
    return getattr(TOWERS.get(config.kind), "token_local", False)


__all__ = [
    "ClassificationHead",
    "ClassificationHeadCatEmbed",
    "CrossAttention",
    "DTYPES",
    "EmbeddingWrapper",
    "FinalAttention",
    "GEGLUFeedForward",
    "GatedMLP",
    "LatentAttentionTower",
    "POOLING",
    "ReducingModel",
    "ResizeWrapperModel",
    "SelfAttention",
    "TokenAttentionPool",
    "TransformerEncoder",
    "TransformerLayer",
    "TransformerTower",
    "WeightedSumModel",
    "average_pool",
    "build_tower",
    "check_tower_input_dim",
    "first_token_pool",
    "last_token_pool",
    "pooling_for_architecture",
    "supports_flat_scoring",
]
