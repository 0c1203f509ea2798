"""User towers, keyed by ``TowerConfig``. This slice ports the latent tower."""

from __future__ import annotations

import torch
from torch import nn

from ..config import TowerConfig
from .latent_attention import CrossAttention, GEGLUFeedForward, LatentAttentionTower
from .pooling import average_pool

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def build_tower(config: TowerConfig) -> nn.Module:
    """The user tower of ``config.kind``, its parameters in
    ``config.param_dtype`` and its matmuls in ``config.compute_dtype``
    (LayerNorm, softmax and pool stay float32)."""
    if config.kind != "latent":
        raise NotImplementedError(
            f"tower kind {config.kind!r} is not ported yet (ROADMAP.md §1, "
            "'The other towers and the padded path'); only 'latent' is"
        )
    return LatentAttentionTower(
        dim=config.reduced_dim,
        num_latents=config.num_latents,
        heads=config.num_heads,
        dim_head=config.latent_dim_head,
        compute_dtype=DTYPES[config.compute_dtype],
    ).to(DTYPES[config.param_dtype])


def check_tower_input_dim(
    config: TowerConfig, dim: int, flag_hint: str = "--dim"
) -> None:
    """The news-embedding width must equal ``reduced_dim``: the towers are
    residual in their input, and their user vector is cosine-scored against
    the D-wide news embeddings."""
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
    token up to the final pool (the latent tower: each token attends to the
    shared latents), so the tower can run over the flat token stream."""
    return config.kind == "latent"


__all__ = [
    "CrossAttention",
    "DTYPES",
    "GEGLUFeedForward",
    "LatentAttentionTower",
    "average_pool",
    "build_tower",
    "check_tower_input_dim",
    "supports_flat_scoring",
]
