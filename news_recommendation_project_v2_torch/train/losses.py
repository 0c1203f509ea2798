"""Training losses, as the JAX package defines them.

- ``margin_ranking_loss``: ``max(0, -(pos - neg) + margin)``, masked mean
  (torch ``MarginRankingLoss`` with target +1). With cosine scores in
  [-1, 1] and margin 2 the hinge never saturates.
- ``infonce_loss``: cross-entropy of the positive against ``k`` sampled
  negatives, the ``-1`` pads masked by a bias of the type's finite minimum
  (not ``-inf``, whose gradient is NaN where a whole row is masked).
"""

from __future__ import annotations

from typing import Optional

import torch


def margin_ranking_loss(
    pos_scores: torch.Tensor,  # [B]
    neg_scores: torch.Tensor,  # [B]
    margin: float = 2.0,
    pair_mask: Optional[torch.Tensor] = None,  # [B] 1 for real pairs
) -> torch.Tensor:
    losses = torch.clamp_min(-(pos_scores - neg_scores) + margin, 0.0)
    if pair_mask is None:
        return losses.mean()
    pair_mask = pair_mask.to(losses.dtype)
    return (losses * pair_mask).sum() / pair_mask.sum().clamp_min(1.0)


def infonce_loss(
    pos_scores: torch.Tensor,  # [B]
    neg_scores: torch.Tensor,  # [B, K]
    neg_valid: torch.Tensor,  # [B, K] 1 where the negative is real (not a -1 pad)
    temperature: float = 1.0,
    pair_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    logits = torch.cat([pos_scores[:, None], neg_scores], dim=1) / temperature
    bias = torch.cat(
        [torch.zeros_like(pos_scores[:, None]), (1.0 - neg_valid) * torch.finfo(logits.dtype).min],
        dim=1,
    )
    losses = -torch.log_softmax(logits + bias, dim=1)[:, 0]
    if pair_mask is None:
        return losses.mean()
    pair_mask = pair_mask.to(losses.dtype)
    return (losses * pair_mask).sum() / pair_mask.sum().clamp_min(1.0)
