"""Latent-attention user tower (NV-Embed style), the flagship history pooler.

History items are the queries and 64 learned latents the context of a PreNorm
cross-attention; a PreNorm GEGLU feed-forward follows; both add residually;
a masked mean-pool and an L2 normalisation end it. Parameter names follow the
reference's torch module (``latents``, ``cross_attend_blocks.{0,1}...``), so
the JAX package's ``convert_latent_attention`` reads this ``state_dict``.

The cross-attention runs through ``ops.latent_attention`` and the
feed-forward through ``ops.geglu``: CUDA kernels on the card, their plain
versions on the CPU. Matmuls run in ``compute_dtype``; LayerNorm, softmax and
the pool stay float32, as in the JAX package's mixed precision.

The tower trains through both kernels: under autograd each wrapper goes
through its ``torch.autograd.Function`` (the kernel forward, a plain
backward), and the casts to ``compute_dtype`` are differentiable. Like the
JAX tower it has no dropout, so a train step needs no random stream.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import REDUCED_DIM
from ..ops.geglu import geglu
from ..ops.latent_attention import latent_attention

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32 whatever the parameter and input types."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
    )


def _project(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A bias-free projection in x's type; a tensor-parallel shard
    (``parallel.sharding.shard_encoder_params_tp``) computes and gathers
    its own part."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype))


class CrossAttention(nn.Module):
    """q from x; k and v from the context, which every batch row shares, so
    they are computed once; no bias, no mask."""

    def __init__(
        self,
        query_dim: int,
        context_dim: int,
        heads: int = 8,
        dim_head: int = 512,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.heads, self.dim_head, self.compute_dtype = heads, dim_head, compute_dtype
        inner = heads * dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, query_dim, bias=False)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """x [B, L, query_dim], context [N, context_dim] -> [B, L, query_dim]
        in ``compute_dtype``."""
        cdt, hd, dh = self.compute_dtype, self.heads, self.dim_head
        b, l, _ = x.shape
        n = context.shape[0]
        q = _project(self.to_q, x.to(cdt))
        q = q.view(b, l, hd, dh).permute(0, 2, 1, 3).contiguous()
        k, v = _project(self.to_kv, context.to(cdt)).chunk(2, dim=-1)
        k = k.reshape(n, hd, dh).permute(1, 0, 2).contiguous()
        v = v.reshape(n, hd, dh).permute(1, 0, 2).contiguous()
        ctx = latent_attention(q, k, v)  # [B, H, L, dh]
        # q goes before the output's permuted copy is made: at the flat
        # eval's chunks each of these blocks is gigabytes.
        del q
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, l, hd * dh)
        return F.linear(ctx, self.to_out.weight.to(cdt))


class GEGLUFeedForward(nn.Module):
    """``proj_out(h * gelu_tanh(g))`` with ``[h, g] = proj_in(x)``."""

    def __init__(self, dim: int, mult: int = 4, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        # Keys follow the reference's nn.Sequential indices (its net.1 is the
        # parameter-free GEGLU), so state_dict names match.
        self.net = nn.ModuleDict(
            {"0": nn.Linear(dim, dim * mult * 2), "2": nn.Linear(dim * mult, dim)}
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., dim] -> [..., dim] in ``compute_dtype``: the kernel sums in
        float32 and the result is rounded once, as flax's ``proj_out``
        returns its compute type."""
        cdt = self.compute_dtype
        proj_in, proj_out = self.net["0"], self.net["2"]
        params = (proj_in.weight, proj_in.bias, proj_out.weight, proj_out.bias)
        x2 = x.reshape(-1, x.shape[-1]).to(cdt).contiguous()
        y = geglu(x2, *(p.to(cdt) for p in params))
        return y.to(cdt).reshape(x.shape)


class PreNorm(nn.Module):
    """A block with its LayerNorms, under the reference's names (``fn``,
    ``norm`` and, for the cross-attention, ``norm_context``)."""

    def __init__(self, dim: int, fn: nn.Module, context_dim: Optional[int] = None):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        if context_dim is not None:
            self.norm_context = nn.LayerNorm(context_dim, eps=LAYER_NORM_EPS)


class LatentAttentionTower(nn.Module):
    # Each token's state depends on that token alone up to the pool, so the
    # tower may run over the flat token stream (``models.supports_flat_scoring``).
    token_local = True

    def __init__(
        self,
        dim: int = REDUCED_DIM,
        num_latents: int = 64,
        heads: int = 8,
        dim_head: int = 512,
        output_normalize: bool = True,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim = dim  # the width of the per-token states and the pooled vector
        self.output_normalize = output_normalize
        self.latents = nn.Parameter(torch.randn(num_latents, dim))
        self.cross_attend_blocks = nn.ModuleList(
            [
                PreNorm(
                    dim,
                    CrossAttention(dim, dim, heads, dim_head, compute_dtype),
                    context_dim=dim,
                ),
                PreNorm(dim, GEGLUFeedForward(dim, compute_dtype=compute_dtype)),
            ]
        )

    def forward(
        self,
        embeddings: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """embeddings [B, L, D], attention_mask [B, L] -> pooled [B, D]; with
        ``attention_mask=None`` the per-token states [B, L, D] (the flat path
        pools them itself). ``generator`` is taken for the padded train
        steps' sake and unused: the tower has no dropout."""
        del generator
        attn, ff = self.cross_attend_blocks
        h = embeddings
        ctx = _layer_norm(attn.norm_context, self.latents)
        h = attn.fn(_layer_norm(attn.norm, h), ctx) + h
        h = ff.fn(_layer_norm(ff.norm, h)) + h
        if attention_mask is None:
            return h
        m = attention_mask.float()
        pooled = pool_epilogue((h.float() * m[..., None]).sum(dim=1), m.sum(dim=1), self.output_normalize)
        return pooled.to(h.dtype)


def pool_epilogue(sums: torch.Tensor, lens: torch.Tensor, normalize: bool) -> torch.Tensor:
    """The tower's pool after the sum of each row's token states, in float32:
    ``sums`` [R, D] over ``max(lens, 1)`` tokens (a fully padded row stays
    zero), then, if ``normalize``, the L2 norm. The padded call and the flat
    paths (the eval's chunks, the train step) all end with it."""
    user = sums / lens.clamp_min(1.0)[:, None]
    if normalize:
        user = user / torch.sqrt((user * user).sum(-1, keepdim=True) + 1e-12)
    return user
