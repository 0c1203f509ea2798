"""Kernels written by hand for Hopper (``csrc/``), their wrappers and plain
versions, and the embedding-dump I/O."""

from .geglu import geglu, reference_geglu
from .latent_attention import latent_attention, reference_attention

__all__ = ["geglu", "latent_attention", "reference_attention", "reference_geglu"]
