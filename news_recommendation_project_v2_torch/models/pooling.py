"""Sequence pooling: last-token, first-token and masked-mean pooling of
[B, L, D] hidden states under a [B, L] mask, and the dispatch by encoder
architecture name."""

from __future__ import annotations

import torch


def last_token_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The last real token of each row: [B, L, D], [B, L] -> [B, D].

    When every row's last position is real the batch is left-padded and the
    last position is taken; otherwise each row's ``sum(mask) - 1``-th position
    (right padding). A row with no real token takes its last position, as the
    JAX package's ``take_along_axis`` wraps the index -1."""
    left_padded = mask[:, -1].sum() == mask.shape[0]
    last = (mask.sum(dim=1) - 1).long() % hidden.shape[1]
    right = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    return torch.where(left_padded, hidden[:, -1], right)


def first_token_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The first position of each row (CLS pooling); the mask is unused."""
    del mask
    return hidden[:, 0]


def average_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the history axis: [B, L, D], [B, L] -> [B, D]. The
    Ranker's scorer when no tower checkpoint is given, and config[0]'s
    user vector."""
    m = mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


POOLING = {
    "last": last_token_pool,
    "first": first_token_pool,
    "mean": average_pool,
}


def pooling_for_architecture(architecture: str):
    """The pooling an encoder architecture's embeddings use: last token for
    Qwen2, the first for gte's ``NewModel``, the masked mean for
    XLM-RoBERTa (e5); the first token otherwise."""
    return {
        "Qwen2ForCausalLM": last_token_pool,
        "NewModel": first_token_pool,
        "XLMRobertaModel": average_pool,
    }.get(architecture, first_token_pool)
