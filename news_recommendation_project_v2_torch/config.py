"""Constants and the user-tower configuration (the port's own copy)."""

from __future__ import annotations

import dataclasses
from typing import Optional

EMBEDDING_DIM = 1024
REDUCED_DIM = EMBEDDING_DIM
IMPRESSION_MAXLEN = 600

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
