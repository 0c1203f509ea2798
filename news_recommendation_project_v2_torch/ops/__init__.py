"""Kernels written by hand for Hopper (``csrc/``), their wrappers and plain
versions, the eval's scoring and the embedding-dump I/O."""

from .geglu import geglu, reference_geglu
from .latent_attention import latent_attention, reference_attention

_SCORING = ("cosine_scores_flat", "score_all_impressions", "user_vectors_bucketed", "user_vectors_flat")

__all__ = ["geglu", "latent_attention", "reference_attention", "reference_geglu", *_SCORING]


def __getattr__(name: str):
    # The scoring names load on first use: ``ops.scoring`` imports
    # ``models``, whose modules import the kernel wrappers above.
    if name in _SCORING:
        from . import scoring

        return getattr(scoring, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
