"""Kimi Delta Attention (KDA), the linear-attention token mixer of Kimi
Linear (arXiv:2510.26692), over right-padded [B, T] rows.

For a token x_t (normed), per head of ``head_dim`` (H heads):

- q, k, v: ``q_proj``, ``k_proj``, ``v_proj`` (D -> H·head_dim), each then
  a depthwise causal conv of ``conv_size`` along the row
  (``q_conv1d`` ..., no bias) and SiLU;
- q and k L2-normalised per head (``x / sqrt(sum x^2 + 1e-6)``), q scaled
  by head_dim ** -0.5;
- a decay per channel, log alpha_t = -exp(``A_log``[h]) ·
  softplus(``f_b_proj``(``f_a_proj``(x_t)) + ``dt_bias``);
- beta_t = sigmoid(``b_proj``(x_t)), one a head;
- the delta rule (``ops.kda``), S_0 = 0 at each row's start;
- the output RMSNorm'd per head (``o_norm``), times
  sigmoid(``g_b_proj``(``g_a_proj``(x_t))), then ``o_proj``.

The projections multiply in the compute type; the convs, the decay, beta,
the L2 norms and the gated norm are float32 (``ops.kda``'s ``kda_prep`` and
``kda_gated_norm``, each one kernel on the card), and so is the state. A
pad follows every real token of its row, so it changes no real token's
state or output; the recurrence writes 0 at pads. Parameter names are
Hugging Face's (``KimiDeltaAttention``); ``A_log`` holds one value a head
and ``dt_bias`` one a channel.

Counters (``utils.profiling``): ``kda.tokens_real`` and
``kda.tokens_computed`` (rows x width), summed over KDA layers, and
``kda.launches``, the recurrence's kernel launches; each layer runs inside
the span ``kda.layer``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kda import kda, kda_gated_norm, kda_prep
from ..utils import profiling


class GatedNormWeight(nn.Module):
    """``o_norm``: the per-head RMSNorm's scale and epsilon (the gate is the
    layer's own)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))


class KimiDeltaAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, conv_size: int, eps: float):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        for name in ("q", "k", "v"):
            self.add_module(f"{name}_proj", nn.Linear(dim, inner, bias=False))
            self.add_module(f"{name}_conv1d", nn.Conv1d(inner, inner, conv_size, groups=inner, bias=False))
        self.A_log = nn.Parameter(torch.zeros(heads))
        self.dt_bias = nn.Parameter(torch.zeros(inner))
        self.f_a_proj = nn.Linear(dim, head_dim, bias=False)
        self.f_b_proj = nn.Linear(head_dim, inner, bias=False)
        self.b_proj = nn.Linear(dim, heads, bias=False)
        self.g_a_proj = nn.Linear(dim, head_dim, bias=False)
        self.g_b_proj = nn.Linear(head_dim, inner, bias=False)
        self.o_norm = GatedNormWeight(head_dim, eps)
        self.o_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, lens: Optional[torch.Tensor] = None, real_tokens: int = 0) -> torch.Tensor:
        """x [B, T, D] normed, in the compute type; ``lens`` [B] int32 the
        rows' real lengths on x's device (``None``: T); ``real_tokens`` their
        sum, known on the host (the counter's). -> [B, T, D]."""
        with profiling.span("kda.layer"):
            out = self._forward(x, lens)
        if profiling.active():
            profiling.count("kda.tokens_real", int(real_tokens))
            profiling.count("kda.tokens_computed", x.shape[0] * x.shape[1])
            profiling.count("kda.launches", 0 if x.is_cpu else 1)
        return out

    def _forward(self, x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
        h, hd, dt = self.heads, self.head_dim, x.dtype

        def linear(name: str, y: torch.Tensor) -> torch.Tensor:
            return F.linear(y, getattr(self, name).weight.to(dt))

        q, k, v, log_alpha = kda_prep(
            linear("q_proj", x), linear("k_proj", x), linear("v_proj", x), linear("f_b_proj", linear("f_a_proj", x)),
            [getattr(self, f"{n}_conv1d").weight for n in ("q", "k", "v")], self.A_log, self.dt_bias, h, hd**-0.5,
        )
        beta = torch.sigmoid(linear("b_proj", x).float())
        o = kda(q, k, v, log_alpha, beta, lens)
        o = kda_gated_norm(o, linear("g_b_proj", linear("g_a_proj", x)), self.o_norm.weight, self.o_norm.eps)
        return linear("o_proj", o)
