"""Transformer history tower: packed-QKV self-attention and gated-GELU
feed-forward blocks, with a per-dimension exp-weight readout.

The port of the JAX package's ``models/attention.py``, whose attention is
plain jnp (no Pallas kernel): here plain PyTorch, matmuls on cuBLAS. The
semantics kept exactly:

- ``SelfAttention`` masks by adding ``(1 - mask) * finfo(float32).min`` to
  float32 logits, so a fully padded row softmaxes to a uniform distribution
  and stays finite (a ``-inf`` fill would give NaN on the all-pad rows every
  padded train batch has).
- ``GatedMLP`` uses the tanh approximation of GELU (flax's ``nn.gelu``
  default) and a fixed intermediate width of 3,072 at any hidden size.
- The LayerNorms take epsilon 1e-12.
- ``TransformerLayer(as_built=True)`` returns ``g_mlp_layernorm(input)``, as
  the reference's layer does (its result is overwritten); the attention and
  feed-forward parameters exist but are inert, so they get no gradient, and
  the optimizer treats that as a zero gradient (``train.trainer.ClippedAdamW``).
  The dead branch is not computed.
- ``TransformerTower``'s readout takes ``exp(w)`` in float32 without
  subtracting a maximum, normalises per dimension over the history axis with
  ``+ 1e-10``, and casts back to the encoder's output type.

Matmuls run in ``compute_dtype``; the softmax, the LayerNorms and the readout
in float32. Parameter names follow the reference torch modules, so the JAX
package's ``convert_transformer_tower`` and ``convert_token_attention_pool``
read these ``state_dict``s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NUM_HIDDEN_LAYERS, REDUCED_DIM
from .layers import dense, dropout, layer_norm32
from .pooling import last_token_pool

LAYER_NORM_EPS = 1e-12
INTERMEDIATE_SIZE = 3072


class SelfAttention(nn.Module):
    """8-head self-attention over the history axis, QKV packed in one
    projection, the padding mask additive."""

    def __init__(self, hidden_size: int = REDUCED_DIM, num_heads: int = 8, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.compute_dtype = num_heads, compute_dtype
        self.qkv_proj = nn.Linear(hidden_size, 3 * hidden_size)
        self.o_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """hidden [B, L, H], mask [B, L] -> [B, L, H] in ``compute_dtype``."""
        b, l, h = hidden.shape
        heads = self.num_heads
        q, k, v = (
            t.reshape(b, l, heads, h // heads).transpose(1, 2)
            for t in dense(self.qkv_proj, hidden, self.compute_dtype).chunk(3, dim=-1)
        )
        logits = torch.matmul(q, k.transpose(-1, -2)) * (h // heads) ** -0.5
        bias = (1.0 - mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
        probs = torch.softmax(logits.float() + bias, dim=-1).to(logits.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, h)
        return dense(self.o_proj, ctx, self.compute_dtype)


class GatedMLP(nn.Module):
    """``down_proj(gelu_tanh(gate) * up)`` with ``[up, gate] = up_gate_proj(x)``."""

    def __init__(
        self,
        hidden_size: int = REDUCED_DIM,
        intermediate_size: int = INTERMEDIATE_SIZE,
        dropout_rate: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dropout_rate, self.compute_dtype = dropout_rate, compute_dtype
        self.up_gate_proj = nn.Linear(hidden_size, 2 * intermediate_size, bias=False)
        self.down_proj = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        up, gate = dense(self.up_gate_proj, x, self.compute_dtype).chunk(2, dim=-1)
        gated = dropout(F.gelu(gate, approximate="tanh") * up, self.dropout_rate, generator)
        return dense(self.down_proj, gated, self.compute_dtype)


class TransformerLayer(nn.Module):
    """Post-norm block: attention, dropout, residual, LayerNorm, gated MLP,
    dropout, residual, LayerNorm (always residual: the JAX package's
    ``residual_connection`` is True wherever it is built). ``as_built=True``
    returns ``g_mlp_layernorm(hidden)`` (see the module's docstring)."""

    def __init__(
        self,
        hidden_size: int = REDUCED_DIM,
        dropout_rate: float = 0.1,
        as_built: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dropout_rate, self.as_built = dropout_rate, as_built
        self.attention = SelfAttention(hidden_size, compute_dtype=compute_dtype)
        self.attn_layernorm = nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS)
        self.g_mlp = GatedMLP(hidden_size, dropout_rate=dropout_rate, compute_dtype=compute_dtype)
        self.g_mlp_layernorm = nn.LayerNorm(hidden_size, eps=LAYER_NORM_EPS)

    def forward(
        self, hidden: torch.Tensor, mask: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """[B, L, H], [B, L] -> [B, L, H] float32."""
        if self.as_built:
            return layer_norm32(self.g_mlp_layernorm, hidden)
        attn = dropout(self.attention(hidden, mask), self.dropout_rate, generator) + hidden
        attn = layer_norm32(self.attn_layernorm, attn)
        mlp = dropout(self.g_mlp(attn, generator), self.dropout_rate, generator) + attn
        return layer_norm32(self.g_mlp_layernorm, mlp)


class TransformerEncoder(nn.Module):
    """``num_layers`` ``TransformerLayer``s (``state_dict`` names
    ``layer.{i}.*``)."""

    def __init__(
        self,
        hidden_size: int = REDUCED_DIM,
        num_layers: int = NUM_HIDDEN_LAYERS,
        dropout_rate: float = 0.1,
        as_built: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(hidden_size, dropout_rate, as_built, compute_dtype) for _ in range(num_layers)
        )

    def forward(
        self, hidden: torch.Tensor, mask: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for layer in self.layer:
            hidden = layer(hidden, mask, generator)
        return hidden


class TransformerTower(nn.Module):
    """The encoder over the history embeddings, then the per-dimension
    exp-weight readout ``linear1``: [B, L, D], [B, L] -> [B, D]."""

    def __init__(
        self,
        hidden_size: int = REDUCED_DIM,
        num_layers: int = NUM_HIDDEN_LAYERS,
        dropout_rate: float = 0.1,
        as_built: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = TransformerEncoder(
            hidden_size, num_layers, dropout_rate, as_built, compute_dtype=compute_dtype
        )
        self.linear1 = nn.Linear(hidden_size, hidden_size)

    def forward(
        self,
        embeddings: torch.Tensor,
        attention_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        res = self.encoder(embeddings, attention_mask, generator)
        return exp_weight_readout(res, dense(self.linear1, res, self.compute_dtype), attention_mask)


def exp_weight_readout(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``sum_l x * exp(w) / (sum_l exp(w) + 1e-10)`` per dimension over the
    history axis, masked, in float32 with no maximum subtracted, cast back to
    ``x``'s type (the readout of ``TransformerTower`` and ``FinalAttention``)."""
    w = torch.exp(w.float()) * mask[..., None].float()
    w = w / (w.sum(dim=1, keepdim=True) + 1e-10)
    return (x.float() * w).sum(dim=1).to(x.dtype)


class TokenAttentionPool(nn.Module):
    """A float32 encoder over frozen per-token states, then the last real
    token: [B, T, D], [B, T] -> [B, D]."""

    def __init__(self, hidden_size: int = REDUCED_DIM, num_layers: int = NUM_HIDDEN_LAYERS, as_built: bool = False):
        super().__init__()
        self.encoder = TransformerEncoder(hidden_size, num_layers, as_built=as_built)

    def forward(
        self,
        token_states: torch.Tensor,
        attention_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return last_token_pool(self.encoder(token_states, attention_mask, generator), attention_mask)
