"""Host-side utilities: the in-flight dispatch window, batch sizing and
profiling."""

from .memory import (
    encoder_activation_bytes,
    estimate_e2e_unique_news,
    estimate_encoder_batch,
    estimate_flat_chunk,
    estimate_head_batch,
    estimate_token_attention_batch,
    estimate_tower_batch,
    estimate_tower_train_batch,
    flat_token_bytes,
    geglu_scratch_bytes,
    tower_activation_bytes,
    transformer_activation_bytes,
)
from .profiling import profile_trace, timed

__all__ = [
    "encoder_activation_bytes",
    "estimate_e2e_unique_news",
    "estimate_encoder_batch",
    "estimate_flat_chunk",
    "estimate_head_batch",
    "estimate_token_attention_batch",
    "estimate_tower_batch",
    "estimate_tower_train_batch",
    "flat_token_bytes",
    "geglu_scratch_bytes",
    "profile_trace",
    "timed",
    "tower_activation_bytes",
    "transformer_activation_bytes",
]
