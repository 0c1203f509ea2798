"""Pieces the padded towers share: a linear layer in the compute type, a
LayerNorm in float32, and dropout drawn from an explicit generator.

Mixed precision follows the JAX package's flax modules: parameters stay in
their own type and a ``Dense`` casts its input and parameters to the compute
type; a LayerNorm computes in float32 and returns float32; adding a compute
type block to a float32 residual gives float32, as in JAX's promotion.

Dropout is flax's ``nn.Dropout``: keep each value with probability
``1 - rate`` and divide the kept ones by it. It runs only when a
``torch.Generator`` is given (the train steps pass the trainer's, seeded from
``TrainConfig.seed``, so two runs draw the same masks); with none the module
is deterministic, as flax's ``deterministic=True``. No stream matches flax's
``jax.random`` bits: the port and the JAX package agree with dropout off.
A ``BatchDraw`` in the generator's place draws over a padded batch's whole
rows for a block cut to its first rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``linear(x)`` with the input and the parameters cast to ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


def layer_norm32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32 whatever the parameter and input types."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)


class BatchDraw:
    """The dropout stream of a block holding the first rows of a padded
    batch of ``rows``: each draw is taken over ``rows`` rows, as over the
    whole block, and its first rows kept, so that the kept masks and the
    generator's state after the draw are the whole block's (a CUDA
    generator's draw of fewer rows is no prefix of a larger draw)."""

    def __init__(self, generator: torch.Generator, rows: int):
        self.generator, self.rows = generator, rows

    def rand(self, shape: torch.Size, device: torch.device) -> torch.Tensor:
        return torch.rand((self.rows, *shape[1:]), generator=self.generator, device=device)[: shape[0]]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator | BatchDraw]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if isinstance(generator, BatchDraw):
        draw = generator.rand(x.shape, x.device)
    else:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep_prob, x / keep_prob, torch.zeros_like(x))
