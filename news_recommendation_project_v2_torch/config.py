"""Constants, the user-tower configuration and the training settings (the
port's own copy)."""

from __future__ import annotations

import dataclasses
from typing import Optional

EMBEDDING_DIM = 1024
REDUCED_DIM = EMBEDDING_DIM
IMPRESSION_MAXLEN = 600

# The default training seed, as in the JAX package.
DEFAULT_SEED = 1234

# Static shape buckets: ragged history / impression lengths pad up to the
# nearest bucket, so the serving path sees a small, fixed set of shapes.
HISTORY_BUCKETS: tuple[int, ...] = (16, 32, 64, 128, 256, IMPRESSION_MAXLEN)
IMPRESSION_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 300)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (lengths beyond the last bucket are truncated to it)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """User-tower architecture. The latent tower's cross-attention always runs
    through the CUDA kernel on the card (its plain version on the CPU), so the
    JAX package's ``fused_attention`` switch has no counterpart here."""

    kind: str = "latent"  # final_attention | transformer | latent
    embedding_dim: int = EMBEDDING_DIM
    reduced_dim: int = REDUCED_DIM
    hidden_dim: int = 4096
    num_heads: int = 8
    num_layers: int = 1
    num_latents: int = 64
    latent_dim_head: int = 512
    dropout_rate: float = 0.1
    as_built: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings: a global-norm clip, then AdamW (betas 0.9 and
    0.999, eps 1e-8, ``weight_decay`` on every parameter); the margin-2
    ranking loss or InfoNCE against ``num_neg_per_pos`` sampled negatives."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    grad_clip_norm: float = 0.5
    margin: float = 2.0
    num_epochs: int = 5
    batch_size: int = 512
    num_neg_per_pos: int = 5
    max_neg_ratio: Optional[float] = None
    max_pos_ratio: Optional[float] = None
    seed: int = DEFAULT_SEED
    loss: str = "margin"  # margin | infonce
    # ReduceLROnPlateau(patience): multiply the lr by ``plateau_factor`` after
    # ``plateau_patience`` epochs without val-metric improvement. 0 disables.
    plateau_patience: int = 0
    plateau_factor: float = 0.1
    # Fetch the step loss to the host every N steps (each fetch waits for the
    # card); every step's loss is still recorded.
    loss_sync_every: int = 1


def tower_kwargs_for_dim(dim: Optional[int]) -> dict:
    """The CLI's ``--dim`` -> TowerConfig overrides, so a checkpoint trained
    at ``--dim X`` restores everywhere."""
    if not dim:
        return {}
    return dict(
        embedding_dim=dim,
        reduced_dim=dim,
        hidden_dim=4 * dim,
        num_latents=min(64, dim),
        latent_dim_head=max(8, dim // 2),
    )
