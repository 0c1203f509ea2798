"""The news-text encoder: text token ids -> pooled, L2-normalised news
vectors, or per-token hidden states for the token store.

Four layouts, chosen by ``EncoderConfig.arch``:

- ``"bert"``: the post-norm BERT/XLM-R encoder of the e5 family (learned
  RoBERTa positions, one token-type row, exact GELU);
- ``"qwen2"``: the decoder layout that Qwen2, Mistral and Llama share
  (rotate-half rotary positions, RMSNorm, grouped-query attention, a
  SiLU-gated MLP, a causal mask); q/k/v carry biases by ``qkv_bias``.
  NV-Embed is this layout with ``bidirectional`` (a padding-only mask) and
  ``latent_pool`` (the latent-attention tower as the pooling head, whose
  cross-attention and GEGLU run through the port's two CUDA kernels);
- ``"deepseek_v3"``: DeepSeek-V3's decoder (Moonlight): multi-head latent
  attention in its expanded form (``kv_b_proj`` makes each head's key and
  value from the ``kv_lora_rank`` latent, the one rotary key is broadcast to
  every head), DeepSeek's interleaved rotary dims, the first
  ``first_k_dense_replace`` layers with a dense MLP and the rest a mixture
  of experts (``models.moe``) over the batch's real tokens only, packed into
  rows on the device (a pad position's state is read by no real token:
  right padding, causal);
- ``"kimi_linear"``: Kimi Linear's hybrid decoder: each layer's token mixer
  is Kimi Delta Attention (``models.kda``, a linear-attention recurrence
  through the port's chunked kernel) or the latent attention above without
  rotation (``mla_use_nope``: the 64 rotary dims kept as they are, causal
  by ``scaled_dot_product_attention``), by ``layer_kinds``; the MLPs as
  DeepSeek-V3's, the MoE layers holding ``experts_held`` of the experts.

Parameter names are HuggingFace's (``XLMRobertaModel``/``BertModel``,
``Qwen2Model``/``MistralModel``/``LlamaModel``, ``DeepseekV3Model`` with its
experts stacked; the head under ``latent_pool.``), so a checkpoint's state
dict loads through ``load_state_dict`` once
``models.convert.encoder_state_dict_from_hf`` has stripped its task prefixes
(and stacked DeepSeek's experts). Matmuls run in ``compute_dtype``, the pooling
head's too; LayerNorm, RMSNorm, the softmaxes and the pools compute in
float32; hidden states leave in float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig
from . import DTYPES
from .kda import GatedNormWeight, KimiDeltaAttention
from .latent_attention import LatentAttentionTower
from .moe import MoEBlock, MoEExperts, MoEGate, swiglu
from .pooling import POOLING


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on x in x's type (the compute type); a tensor-parallel shard
    (``parallel.sharding.shard_encoder_params_tp``) computes its own part."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(dtype)


def _attention(q, k, v, bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v over [B, H, T, hd] blocks; the
    logits in the compute type, the softmax in float32."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    probs = torch.softmax((logits + bias.to(logits.dtype)).float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


class EncoderLayer(nn.Module):
    """A post-norm BERT/XLM-R block: self-attention, residual, LayerNorm; an
    exact-GELU MLP, residual, LayerNorm."""

    def __init__(self, hidden_dim: int, num_heads: int, intermediate_dim: int, eps: float):
        super().__init__()
        self.num_heads = num_heads
        d = hidden_dim
        self.attention = nn.ModuleDict(
            {
                "self": nn.ModuleDict({"query": nn.Linear(d, d), "key": nn.Linear(d, d), "value": nn.Linear(d, d)}),
                "output": nn.ModuleDict({"dense": nn.Linear(d, d), "LayerNorm": nn.LayerNorm(d, eps=eps)}),
            }
        )
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(d, intermediate_dim)})
        self.output = nn.ModuleDict({"dense": nn.Linear(intermediate_dim, d), "LayerNorm": nn.LayerNorm(d, eps=eps)})

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """hidden [B, T, D] in the compute type; bias [B, 1, 1, T] additive."""
        b, t, d = hidden.shape
        sa, out = self.attention["self"], self.attention["output"]

        def split(x):
            return x.view(b, t, self.num_heads, -1).transpose(1, 2)

        q, k, v = (split(_linear(sa[n], hidden)) for n in ("query", "key", "value"))
        ctx = _attention(q, k, v, bias).transpose(1, 2).reshape(b, t, -1)  # this rank's heads under TP
        hidden = _layer_norm(out["LayerNorm"], hidden + _linear(out["dense"], ctx), hidden.dtype)
        inter = F.gelu(_linear(self.intermediate["dense"], hidden))
        ffn = _linear(self.output["dense"], inter)
        return _layer_norm(self.output["LayerNorm"], hidden + ffn, hidden.dtype)


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x^2) + eps) * weight`` in float32, returned in x's type."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()
        return y.to(x.dtype)


def rope_cos_sin(t: int, head_dim: int, theta: float, dtype: torch.dtype, device) -> tuple:
    """Rotate-half rotary tables [T, head_dim] for positions 0..T-1: the
    frequency vector repeated twice (HF's convention, not interleaved),
    computed in float32 and cast to ``dtype``."""
    inv_freq = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    freqs = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class DecoderLayer(nn.Module):
    """A pre-norm Qwen2/Mistral/Llama block: RMSNorm, grouped-query attention
    with rotary positions (q/k/v biased by ``qkv_bias``, o without),
    residual; RMSNorm, ``down(silu(gate(x)) * up(x))`` without biases,
    residual."""

    def __init__(
        self, hidden_dim: int, num_heads: int, num_kv_heads: int, head_dim: int, intermediate_dim: int,
        eps: float, qkv_bias: bool,
    ):
        super().__init__()
        self.num_heads, self.num_kv_heads, self.head_dim = num_heads, num_kv_heads, head_dim
        d, h, kv, hd = hidden_dim, num_heads, num_kv_heads, head_dim
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = nn.ModuleDict(
            {
                "q_proj": nn.Linear(d, h * hd, bias=qkv_bias),
                "k_proj": nn.Linear(d, kv * hd, bias=qkv_bias),
                "v_proj": nn.Linear(d, kv * hd, bias=qkv_bias),
                "o_proj": nn.Linear(h * hd, d, bias=False),
            }
        )
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = nn.ModuleDict(
            {
                "gate_proj": nn.Linear(d, intermediate_dim, bias=False),
                "up_proj": nn.Linear(d, intermediate_dim, bias=False),
                "down_proj": nn.Linear(intermediate_dim, d, bias=False),
            }
        )

    def forward(self, hidden, cos, sin, bias) -> torch.Tensor:
        """hidden [B, T, D] in the compute type; cos, sin [T, head_dim];
        bias [B, 1, T, T] additive."""
        b, t, _ = hidden.shape
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn, mlp = self.self_attn, self.mlp
        x = self.input_layernorm(hidden)
        q = _linear(attn["q_proj"], x).view(b, t, h, hd).transpose(1, 2)
        k = _linear(attn["k_proj"], x).view(b, t, kv, hd).transpose(1, 2)
        v = _linear(attn["v_proj"], x).view(b, t, kv, hd).transpose(1, 2)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        if kv != h:  # each kv head serves h // kv query heads in a row
            k = k.repeat_interleave(h // kv, dim=1)
            v = v.repeat_interleave(h // kv, dim=1)
        ctx = _attention(q, k, v, bias).transpose(1, 2).reshape(b, t, h * hd)
        hidden = hidden + _linear(attn["o_proj"], ctx)
        x = self.post_attention_layernorm(hidden)
        return hidden + _linear(mlp["down_proj"], F.silu(_linear(mlp["gate_proj"], x)) * _linear(mlp["up_proj"], x))


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rotary dims come in interleaved pairs (x0, x1, x2, x3, ...);
    its rotary code reorders them to (x0, x2, ..., x1, x3, ...) before the
    rotate-half."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def real_token_positions(mask: torch.Tensor, real_tokens: Optional[int] = None) -> torch.Tensor:
    """The flat positions [n] of a [B, T] mask's real tokens, row-major, on
    the mask's device. ``real_tokens`` is their count, known on the host
    (``None``: read from the mask, which waits for the device); given, no
    step waits: each real position is scattered to its rank among them, the
    pads to one spare slot past the end."""
    flat = mask.reshape(-1) > 0
    n = int(flat.sum()) if real_tokens is None else int(real_tokens)
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, n)
    pos = torch.empty(n + 1, dtype=torch.long, device=mask.device)
    pos.scatter_(0, dest, torch.arange(flat.numel(), device=mask.device))
    return pos[:n]


class MLADecoderLayer(nn.Module):
    """A pre-norm DeepSeek-V3 block: RMSNorm, multi-head latent attention
    (expanded: per-head keys and values from the latent, the shared rotary
    key broadcast, softmax scale (nope + rope) ** -0.5), residual; RMSNorm,
    a dense SwiGLU MLP (``mlp.gate_proj`` ...) or a ``MoEBlock`` over the real
    tokens, residual. No biases. Kimi Linear's blocks take ``kind="kda"``
    (Kimi Delta Attention as the token mixer), or MLA without rotation
    (``cfg.mla_use_nope``), and hold ``cfg.experts_held`` of the experts."""

    def __init__(self, cfg: EncoderConfig, dense: bool, kind: str = "mla"):
        super().__init__()
        d, h, eps = cfg.hidden_dim, cfg.num_heads, cfg.layer_norm_eps
        self.num_heads, self.dense, self.kind = h, dense, kind
        self.rotary = not cfg.mla_use_nope
        self.nope, self.rope, self.v_dim, self.rank = (
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank,
        )
        self.input_layernorm = RMSNorm(d, eps)
        if kind == "kda":
            self.self_attn = KimiDeltaAttention(d, cfg.kda_num_heads, cfg.kda_head_dim, cfg.short_conv_kernel_size, eps)
        elif kind == "mla":
            self.self_attn = nn.ModuleDict(
                {
                    "q_proj": nn.Linear(d, h * (self.nope + self.rope), bias=False),
                    "kv_a_proj_with_mqa": nn.Linear(d, self.rank + self.rope, bias=False),
                    "kv_a_layernorm": RMSNorm(self.rank, eps),
                    "kv_b_proj": nn.Linear(self.rank, h * (self.nope + self.v_dim), bias=False),
                    "o_proj": nn.Linear(h * self.v_dim, d, bias=False),
                }
            )
        else:
            raise ValueError(f"unknown layer kind {kind!r} (kda | mla)")
        self.post_attention_layernorm = RMSNorm(d, eps)
        if dense:
            self.mlp = nn.ModuleDict(
                {
                    "gate_proj": nn.Linear(d, cfg.intermediate_dim, bias=False),
                    "up_proj": nn.Linear(d, cfg.intermediate_dim, bias=False),
                    "down_proj": nn.Linear(cfg.intermediate_dim, d, bias=False),
                }
            )
        else:
            self.mlp = MoEBlock(
                d, cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size,
                cfg.n_shared_experts, cfg.routed_scaling_factor, cfg.norm_topk_prob, cfg.experts_held,
            )

    def _mla(self, x, cos, sin, bias) -> torch.Tensor:
        """The latent attention of the normed block x [B, T, D]; without a
        ``bias``, causal through ``scaled_dot_product_attention`` (right
        padding: a real token's keys are all real)."""
        b, t, d = x.shape
        h, nope, rope = self.num_heads, self.nope, self.rope
        attn = self.self_attn
        q = _linear(attn["q_proj"], x).view(b, t, h, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        latent, k_pe = _linear(attn["kv_a_proj_with_mqa"], x).split([self.rank, rope], dim=-1)
        kv = _linear(attn["kv_b_proj"], attn["kv_a_layernorm"](latent)).view(b, t, h, nope + self.v_dim)
        k_nope, v = kv.transpose(1, 2).split([nope, self.v_dim], dim=-1)
        k_pe = k_pe.view(b, 1, t, rope)
        if self.rotary:
            q_pe, k_pe = deinterleave(q_pe), deinterleave(k_pe)
            q_pe = q_pe * cos + rotate_half(q_pe) * sin
            k_pe = k_pe * cos + rotate_half(k_pe) * sin
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, h, t, rope)], dim=-1)
        if bias is not None:
            ctx = _attention(q, k, v, bias)
        else:
            ctx = _causal_attention(q, k, v)
        return _linear(attn["o_proj"], ctx.transpose(1, 2).reshape(b, t, h * self.v_dim))

    def forward(self, hidden, cos, sin, bias, real: torch.Tensor, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden [B, T, D] in the compute type; cos, sin [T, rope]; bias
        [B, 1, T, T] additive (``None``: causal attention over right-padded
        rows); ``real`` the flat positions of the real tokens
        (``real_token_positions``), which alone go through the experts;
        ``lens`` [B] int32 the rows' real lengths on the device (KDA)."""
        b, t, d = hidden.shape
        x = self.input_layernorm(hidden)
        if self.kind == "kda":
            hidden = hidden + self.self_attn(x, lens, real.numel())
        else:
            hidden = hidden + self._mla(x, cos, sin, bias)
        x = self.post_attention_layernorm(hidden)
        if self.dense:
            return hidden + swiglu(self.mlp, x)
        out = self.mlp(x.reshape(b * t, d).index_select(0, real))
        return hidden + torch.zeros_like(x).view(b * t, d).index_copy_(0, real, out).view(b, t, d)


def _causal_attention(q, k, v) -> torch.Tensor:
    """Causal softmax(q k^T / sqrt(hd)) v over [B, H, T, hd] blocks by
    ``scaled_dot_product_attention`` (no [T, T] block held); on the card v is
    padded with zeros to q's width, so the flash kernel takes it."""
    dv = v.shape[-1]
    if not q.is_cpu and dv < q.shape[-1]:
        v = F.pad(v, (0, q.shape[-1] - dv))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=q.shape[-1] ** -0.5)
    return out[..., :dv]


class NewsEncoder(nn.Module):
    """Token ids [B, T] and mask [B, T] -> pooled news vectors [B, D]
    (``forward``) or per-token states [B, T, D] (``hidden_states``), both
    float32. Padded positions (mask 0) never change a real token's state; a
    fully padded row stays finite."""

    def __init__(self, config: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        d = cfg.hidden_dim
        # The MoE layers route only real tokens: ``encode_corpus`` hands
        # ``forward`` their count, known on the host.
        self.routes_tokens = cfg.arch in ("deepseek_v3", "kimi_linear")
        if cfg.arch == "qwen2":
            self.head_dim = cfg.head_dim or d // cfg.num_heads
            self.rope_dim = self.head_dim
            kv = cfg.num_kv_heads or cfg.num_heads
            self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
            self.layers = nn.ModuleList(
                DecoderLayer(d, cfg.num_heads, kv, self.head_dim, cfg.intermediate_dim, cfg.layer_norm_eps, cfg.qkv_bias)
                for _ in range(cfg.num_layers)
            )
            self.norm = RMSNorm(d, cfg.layer_norm_eps)
        elif cfg.arch in ("deepseek_v3", "kimi_linear"):
            if (cfg.scoring_func, cfg.topk_method) != ("sigmoid", "noaux_tc"):
                raise ValueError(
                    f"{cfg.arch} routes by the sigmoid and noaux_tc only, got {cfg.scoring_func!r} and "
                    f"{cfg.topk_method!r}"
                )
            kinds = ("mla",) * cfg.num_layers
            if cfg.arch == "kimi_linear":
                kinds = tuple(cfg.layer_kinds)
                if len(kinds) != cfg.num_layers:
                    raise ValueError(f"kimi_linear: {len(kinds)} layer kinds for {cfg.num_layers} layers")
            self.rope_dim = cfg.qk_rope_head_dim
            self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
            self.layers = nn.ModuleList(
                MLADecoderLayer(cfg, dense=i < cfg.first_k_dense_replace, kind=kinds[i]) for i in range(cfg.num_layers)
            )
            self.norm = RMSNorm(d, cfg.layer_norm_eps)
        elif cfg.arch == "bert":
            self.embeddings = nn.ModuleDict(
                {
                    "word_embeddings": nn.Embedding(cfg.vocab_size, d),
                    "position_embeddings": nn.Embedding(cfg.max_position, d),
                    "token_type_embeddings": nn.Embedding(1, d),
                    "LayerNorm": nn.LayerNorm(d, eps=cfg.layer_norm_eps),
                }
            )
            self.encoder = nn.ModuleDict(
                {
                    "layer": nn.ModuleList(
                        EncoderLayer(d, cfg.num_heads, cfg.intermediate_dim, cfg.layer_norm_eps)
                        for _ in range(cfg.num_layers)
                    )
                }
            )
        else:
            raise ValueError(f"unknown encoder arch {cfg.arch!r}")
        if cfg.latent_pool:
            # NV-Embed's pooling head: the user tower's module in the
            # encoder's compute type, no normalisation of its own (the
            # encoder's epilogue normalises).
            self.latent_pool = LatentAttentionTower(
                dim=d,
                num_latents=cfg.latent_pool_num_latents,
                heads=cfg.latent_pool_heads,
                dim_head=cfg.latent_pool_dim_head,
                output_normalize=False,
                compute_dtype=self.compute_dtype,
            )
        self.to(DTYPES[cfg.param_dtype])

    def hidden_states(
        self, token_ids: torch.Tensor, mask: torch.Tensor, real_tokens: Optional[int] = None
    ) -> torch.Tensor:
        """The last layer's per-token states [B, T, D], float32 (the token
        store's content). ``real_tokens``, the mask's count of real tokens
        where the caller knows it, spares the MoE layout a wait for the
        device; the other layouts ignore it."""
        if self.config.arch == "kimi_linear":
            return self._hybrid_hidden_states(token_ids, mask, real_tokens)
        if self.config.arch in ("qwen2", "deepseek_v3"):
            return self._decoder_hidden_states(token_ids, mask, real_tokens)
        cdt, emb = self.compute_dtype, self.embeddings
        m = mask.long()
        positions = torch.cumsum(m, dim=1) * m + 1  # RoBERTa: pads skipped, reals from 2
        x = (
            emb["word_embeddings"](token_ids).to(cdt)
            + emb["position_embeddings"](positions).to(cdt)
            + emb["token_type_embeddings"].weight[0].to(cdt)
        )
        hidden = _layer_norm(emb["LayerNorm"], x, cdt)
        bias = (1.0 - mask[:, None, None, :].to(cdt)) * torch.finfo(cdt).min
        for layer in self.encoder["layer"]:
            hidden = layer(hidden, bias)
        return hidden.float()

    def _decoder_hidden_states(
        self, token_ids: torch.Tensor, mask: torch.Tensor, real_tokens: Optional[int] = None
    ) -> torch.Tensor:
        """Positions ``arange(T)`` (right padding keeps real tokens first);
        a causal and padding mask, or padding only with ``bidirectional``, at
        the compute type's finite min, so a fully padded row softmaxes to a
        uniform row instead of NaN; the final RMSNorm."""
        cfg, cdt = self.config, self.compute_dtype
        t = token_ids.shape[1]
        hidden = self.embed_tokens(token_ids).to(cdt)
        cos, sin = rope_cos_sin(t, self.rope_dim, cfg.rope_theta, cdt, token_ids.device)
        keep = mask[:, None, None, :] > 0
        if not cfg.bidirectional:
            keep = keep & torch.ones(t, t, dtype=torch.bool, device=token_ids.device).tril()
        bias = torch.zeros(keep.shape, dtype=torch.float32, device=token_ids.device)
        bias.masked_fill_(~keep, torch.finfo(cdt).min)
        if cfg.arch == "deepseek_v3":
            real = real_token_positions(mask, real_tokens)
            for layer in self.layers:
                hidden = layer(hidden, cos, sin, bias, real)
        else:
            for layer in self.layers:
                hidden = layer(hidden, cos, sin, bias)
        return self.norm(hidden).float()

    def _hybrid_hidden_states(
        self, token_ids: torch.Tensor, mask: torch.Tensor, real_tokens: Optional[int] = None
    ) -> torch.Tensor:
        """Kimi Linear: no positions (KDA has none, its MLA is NoPE), so no
        rotary table and no [T, T] mask: right padding makes every layer
        causal over real tokens alone (KDA's recurrence runs forward, the
        MLA is causal). The rows' lengths go to the KDA layers on the
        device; the final RMSNorm."""
        hidden = self.embed_tokens(token_ids).to(self.compute_dtype)
        real = real_token_positions(mask, real_tokens)
        lens = mask.sum(1, dtype=torch.int32)
        for layer in self.layers:
            hidden = layer(hidden, None, None, None, real, lens)
        return self.norm(hidden).float()

    def forward(
        self,
        token_ids: torch.Tensor,
        mask: torch.Tensor,
        pool_mask: Optional[torch.Tensor] = None,
        real_tokens: Optional[int] = None,
    ) -> torch.Tensor:
        """Pooled vectors [B, D], float32: ``POOLING[config.pooling]`` or the
        latent-attention head, then (``normalize``) the L2 norm. Attention
        reads ``mask``; the pool reads ``pool_mask`` [B, T] where given (NV-Embed
        leaves an instruction's tokens out of the mean, though every token
        attends to them), else ``mask``. ``real_tokens`` as in
        ``hidden_states``."""
        cfg = self.config
        hidden = self.hidden_states(token_ids, mask, real_tokens)
        pool = mask if pool_mask is None else pool_mask
        if cfg.latent_pool:
            pooled = self.latent_pool(hidden, pool.float())
        else:
            pooled = POOLING[cfg.pooling](hidden, pool)
        if cfg.normalize:
            pooled = pooled / torch.sqrt((pooled * pooled).sum(-1, keepdim=True) + 1e-12)
        return pooled


@torch.no_grad()
def init_random_weights(encoder: NewsEncoder, seed: int = 0) -> NewsEncoder:
    """Seeded random weights drawn on the encoder's own device (fast at full
    width on the card): linear weights N(0, 1/fan_in), biases N(0, 0.02^2),
    embeddings N(0, 1), norm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2),
    the head's latents N(0, 1), stacked experts and routers N(0, 1/fan_in),
    the routers' selection biases N(0, 0.02^2); KDA's convs N(0, 1/width),
    ``A_log`` log U(1, 16) and ``dt_bias`` N(0, 1). For tests against the JAX package use
    ``models.convert.random_encoder_params``, which both packages load."""
    gen = torch.Generator(device=next(encoder.parameters()).device).manual_seed(seed)

    def normal_(p: torch.Tensor, scale: float, shift: float = 0.0) -> None:
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32) * scale + shift)

    for module in encoder.modules():
        if isinstance(module, nn.Linear):
            normal_(module.weight, module.in_features**-0.5)
            if module.bias is not None:
                normal_(module.bias, 0.02)
        elif isinstance(module, nn.Embedding):
            normal_(module.weight, 1.0)
        elif isinstance(module, (nn.LayerNorm, RMSNorm)):
            normal_(module.weight, 0.1, 1.0)
            if getattr(module, "bias", None) is not None:
                normal_(module.bias, 0.1)
        elif isinstance(module, LatentAttentionTower):
            normal_(module.latents, 1.0)
        elif isinstance(module, MoEGate):
            normal_(module.weight, module.weight.shape[-1] ** -0.5)
            normal_(module.e_score_correction_bias, 0.02)
        elif isinstance(module, MoEExperts):
            normal_(module.gate_up_proj, module.gate_up_proj.shape[-1] ** -0.5)
            normal_(module.down_proj, module.down_proj.shape[-1] ** -0.5)
        elif isinstance(module, GatedNormWeight):
            normal_(module.weight, 0.1, 1.0)
        elif isinstance(module, KimiDeltaAttention):
            for name in ("q", "k", "v"):
                conv = getattr(module, f"{name}_conv1d").weight
                normal_(conv, conv.shape[-1] ** -0.5)
            module.A_log.copy_(torch.empty_like(module.A_log).uniform_(1.0, 16.0, generator=gen).log())
            normal_(module.dt_bias, 1.0)
    return encoder


# ---------------------------------------------------------------------------
# HF configs and checkpoints
# ---------------------------------------------------------------------------

# HF architectures with a layout here, and the pooling each one's embeddings
# use (Qwen2: the last token; XLM-R (e5): the masked mean; BERT: the first).
# Mistral and Llama share Qwen2's decoder layout without q/k/v biases.
# DeepSeek-V3 (Moonlight) has no published embedding head: it pools as the
# other causal decoders do, at the last real token.
_SUPPORTED_ARCHS = {
    "XLMRobertaModel": ("bert", "mean"),
    "XLMRobertaForMaskedLM": ("bert", "mean"),
    "BertModel": ("bert", "first"),
    "BertForMaskedLM": ("bert", "first"),
    "Qwen2Model": ("qwen2", "last"),
    "Qwen2ForCausalLM": ("qwen2", "last"),
    "MistralModel": ("qwen2", "last"),
    "MistralForCausalLM": ("qwen2", "last"),
    "LlamaModel": ("qwen2", "last"),
    "LlamaForCausalLM": ("qwen2", "last"),
    "DeepseekV3Model": ("deepseek_v3", "last"),
    "DeepseekV3ForCausalLM": ("deepseek_v3", "last"),
    "KimiLinearModel": ("kimi_linear", "last"),
    "KimiLinearForCausalLM": ("kimi_linear", "last"),
}


def _deepseek_v3_fields(hf_config: dict) -> dict:
    """The MLA and MoE fields of a DeepSeek-V3 ``config.json``; raises, each
    in words, on what this layout does not apply."""
    refused = []
    if hf_config.get("q_lora_rank") is not None:
        refused.append(
            f"q_lora_rank={hf_config['q_lora_rank']} (queries through a low-rank latent; only the direct "
            "q_proj of q_lora_rank null is built)"
        )
    for key in ("n_group", "topk_group"):
        if (hf_config.get(key) or 1) > 1:
            refused.append(f"{key}={hf_config[key]} (group-limited routing; only one group of experts is built)")
    if (hf_config.get("num_nextn_predict_layers") or 0) > 0:
        refused.append(
            f"num_nextn_predict_layers={hf_config['num_nextn_predict_layers']} (multi-token-prediction "
            "layers have no place in an encoder)"
        )
    if hf_config.get("scoring_func", "sigmoid") != "sigmoid":
        refused.append(f"scoring_func={hf_config['scoring_func']!r} (only the sigmoid router is built)")
    if hf_config.get("topk_method", "noaux_tc") != "noaux_tc":
        refused.append(f"topk_method={hf_config['topk_method']!r} (only noaux_tc selection is built)")
    if hf_config.get("attention_bias"):
        refused.append("attention_bias=True (the attention's projections are built without biases)")
    if (hf_config.get("moe_layer_freq") or 1) != 1:
        refused.append(f"moe_layer_freq={hf_config['moe_layer_freq']} (every layer past the dense ones is MoE)")
    if refused:
        raise ValueError("DeepSeek-V3 checkpoint settings this encoder does not apply: " + "; ".join(refused))
    return dict(
        kv_lora_rank=hf_config["kv_lora_rank"],
        qk_nope_head_dim=hf_config["qk_nope_head_dim"],
        qk_rope_head_dim=hf_config["qk_rope_head_dim"],
        v_head_dim=hf_config["v_head_dim"],
        n_routed_experts=hf_config["n_routed_experts"],
        num_experts_per_tok=hf_config["num_experts_per_tok"],
        n_shared_experts=hf_config.get("n_shared_experts") or 0,
        moe_intermediate_size=hf_config["moe_intermediate_size"],
        first_k_dense_replace=hf_config.get("first_k_dense_replace", 0),
        routed_scaling_factor=float(hf_config.get("routed_scaling_factor", 1.0)),
        norm_topk_prob=bool(hf_config.get("norm_topk_prob", True)),
        scoring_func="sigmoid",
        topk_method="noaux_tc",
        qkv_bias=False,
    )


def _kimi_linear_fields(hf_config: dict) -> dict:
    """The KDA, MLA and MoE fields of a Kimi Linear ``config.json``; raises,
    each in words, on what this layout does not apply. The top-level
    ``head_dim`` is read by neither kind of layer (KDA's heads are
    ``linear_attn_config.head_dim``, MLA's the nope, rope and v dims)."""
    n = hf_config["num_hidden_layers"]
    lac = hf_config.get("linear_attn_config") or {}
    refused = []
    if hf_config.get("q_lora_rank") is not None:
        refused.append(
            f"q_lora_rank={hf_config['q_lora_rank']} (queries through a low-rank latent; only the direct "
            "q_proj of q_lora_rank null is built)"
        )
    for key in ("num_expert_group", "topk_group"):
        if (hf_config.get(key) or 1) > 1:
            refused.append(f"{key}={hf_config[key]} (group-limited routing; only one group of experts is built)")
    if (hf_config.get("num_nextn_predict_layers") or 0) > 0:
        refused.append(
            f"num_nextn_predict_layers={hf_config['num_nextn_predict_layers']} (multi-token-prediction "
            "layers have no place in an encoder)"
        )
    if hf_config.get("moe_router_activation_func", "sigmoid") != "sigmoid":
        refused.append(
            f"moe_router_activation_func={hf_config['moe_router_activation_func']!r} (only the sigmoid router "
            "is built)"
        )
    if not hf_config.get("mla_use_nope", False):
        refused.append("mla_use_nope=False (the MLA layers are built without rotation only)")
    if (hf_config.get("moe_layer_freq") or 1) != 1:
        refused.append(f"moe_layer_freq={hf_config['moe_layer_freq']} (every layer past the dense ones is MoE)")
    kda = [int(i) for i in lac.get("kda_layers") or []]
    full = [int(i) for i in lac.get("full_attn_layers") or []]
    if sorted(kda + full) != list(range(1, n + 1)):
        refused.append(
            f"linear_attn_config's kda_layers {kda} and full_attn_layers {full} (1-indexed) do not name each of "
            f"the {n} layers exactly once"
        )
    if refused:
        raise ValueError("Kimi Linear checkpoint settings this encoder does not apply: " + "; ".join(refused))
    return dict(
        kv_lora_rank=hf_config["kv_lora_rank"],
        qk_nope_head_dim=hf_config["qk_nope_head_dim"],
        qk_rope_head_dim=hf_config["qk_rope_head_dim"],
        v_head_dim=hf_config["v_head_dim"],
        n_routed_experts=hf_config["num_experts"],
        num_experts_per_tok=hf_config["num_experts_per_token"],
        n_shared_experts=hf_config.get("num_shared_experts") or 0,
        moe_intermediate_size=hf_config["moe_intermediate_size"],
        first_k_dense_replace=hf_config.get("first_k_dense_replace", 0),
        routed_scaling_factor=float(hf_config.get("routed_scaling_factor", 1.0)),
        norm_topk_prob=bool(hf_config.get("moe_renormalize", True)),
        scoring_func="sigmoid",
        topk_method="noaux_tc",
        qkv_bias=False,
        head_dim=None,
        layer_kinds=tuple("kda" if i + 1 in kda else "mla" for i in range(n)),
        kda_num_heads=lac["num_heads"],
        kda_head_dim=lac["head_dim"],
        short_conv_kernel_size=lac.get("short_conv_kernel_size", 4),
        mla_use_nope=True,
    )


def expert_share(held, num_experts: int) -> Optional[tuple[int, int]]:
    """``experts_held`` ``(first, count)`` as a pair of ints; raises unless
    it names one whole range of the ``num_experts`` experts."""
    if held is None:
        return None
    if len(held) != 2:
        raise ValueError(f"experts_held {held!r}: give (first expert, count) of one whole range of experts")
    first, count = (int(x) for x in held)
    if first < 0 or count < 1 or first + count > num_experts:
        raise ValueError(
            f"experts_held (first {first}, count {count}) is not a whole range of the {num_experts} experts"
        )
    return first, count


def encoder_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    """An ``EncoderConfig`` from an HF ``config.json`` dict: the layout and
    pooling by architecture name, the widths, and for decoders the GQA,
    rotary and bias fields. ``NVEmbedModel`` reads its Mistral backbone from
    ``text_config`` and its head from ``latent_attention_config``, and turns
    on ``bidirectional`` and ``latent_pool``. Raises on an unsupported
    architecture, on ``rope_scaling`` (only plain ``rope_theta`` is
    applied), on a ``sliding_window`` under 512 tokens (attention here is
    always full), on an NV-Embed head whose ``latent_dim`` is not the
    backbone's width, and on an NV-Embed config without ``text_config``.
    ``DeepseekV3ForCausalLM`` / ``DeepseekV3Model`` (Moonlight) take the
    ``deepseek_v3`` layout with last-token pooling and their MLA and MoE
    fields; they raise on a ``q_lora_rank``, on ``n_group`` or
    ``topk_group`` over 1, on MTP layers, on a scoring function other than
    the sigmoid (``_deepseek_v3_fields``) and on ``rope_scaling``.
    ``KimiLinearForCausalLM`` / ``KimiLinearModel`` take the ``kimi_linear``
    layout with last-token pooling (``_kimi_linear_fields``, with its own
    refusals); the override ``experts_held`` (``(first, count)``, one whole
    range: ``expert_share``) gives its MoE layers a share of the experts."""
    arch_name = (hf_config.get("architectures") or ["XLMRobertaModel"])[0]
    if arch_name == "NVEmbedModel":
        text = dict(hf_config.get("text_config") or {})
        if not text:
            raise ValueError(
                "NVEmbedModel config has no text_config (the Mistral-family "
                "backbone fields) — is this a complete NV-Embed config.json?"
            )
        text.setdefault("architectures", ["MistralModel"])
        lat = hf_config.get("latent_attention_config") or {}
        latent_dim = lat.get("latent_dim", text.get("hidden_size"))
        if latent_dim != text.get("hidden_size"):
            raise ValueError(
                f"NV-Embed latent_attention latent_dim={latent_dim} != "
                f"backbone hidden_size={text.get('hidden_size')}; the head is "
                "residual in the token stream so these must match"
            )
        return encoder_config_from_hf(
            text,
            **{
                "bidirectional": True,
                "latent_pool": True,
                "latent_pool_num_latents": lat.get("num_latents_value", lat.get("num_latents", 512)),
                "latent_pool_heads": lat.get("num_cross_heads", lat.get("cross_heads", 8)),
                "latent_pool_dim_head": lat.get("cross_dim_head", 4096),
                "pooling": "mean",  # the head mean-pools over tokens itself
                **overrides,
            },
        )
    try:
        arch, pooling = _SUPPORTED_ARCHS[arch_name]
    except KeyError:
        raise ValueError(
            f"architecture {arch_name!r} is not supported; supported HF "
            f"architectures: {sorted(_SUPPORTED_ARCHS)} (BERT/XLM-R encoder "
            "layouts, Qwen2/Mistral/Llama-class decoder layouts, DeepSeek-V3's "
            "MLA and MoE decoder and Kimi Linear's KDA, MLA and MoE hybrid)"
        ) from None
    if hf_config.get("rope_scaling") is not None:
        raise ValueError(
            f"checkpoint {arch_name!r} uses rope_scaling="
            f"{hf_config['rope_scaling']!r}, which this rotary implementation "
            "does not apply (plain rope_theta only) — loading it would "
            "silently diverge from the checkpoint's positional encoding. "
            "Llama-3.1+-style scaled-RoPE checkpoints are out of scope; "
            "Llama/Mistral/Qwen2 checkpoints with rope_scaling null load "
            "natively."
        )
    sliding = hf_config.get("sliding_window")
    max_pos = hf_config.get("max_position_embeddings", 514)
    if sliding is not None and sliding < min(512, max_pos):
        raise ValueError(
            f"checkpoint {arch_name!r} uses sliding_window={sliding} (< the "
            "512-token news texts this framework encodes); attention here is "
            "always full-context, so hidden states would diverge from the "
            "checkpoint's. Windowed-attention checkpoints are out of scope."
        )
    cfg = EncoderConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_dim=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_dim=hf_config["intermediate_size"],
        max_position=max_pos,
        layer_norm_eps=hf_config.get("layer_norm_eps", hf_config.get("rms_norm_eps", 1e-5)),
        pooling=pooling,
        arch=arch,
        num_kv_heads=hf_config.get("num_key_value_heads"),
        head_dim=hf_config.get("head_dim"),
        rope_theta=hf_config.get("rope_theta", 10000.0),
        # Qwen2 always biases q/k/v (its configs predate the field);
        # Mistral and Llama expose attention_bias, default False.
        qkv_bias=hf_config.get("attention_bias", arch_name.startswith("Qwen2")),
    )
    if arch == "deepseek_v3":
        cfg = dataclasses.replace(cfg, **_deepseek_v3_fields(hf_config))
    elif arch == "kimi_linear":
        cfg = dataclasses.replace(cfg, **_kimi_linear_fields(hf_config))
    if "experts_held" in overrides:
        if arch != "kimi_linear" and overrides["experts_held"] is not None:
            raise ValueError(f"experts_held: an expert share is built for the kimi_linear layout only, not {arch!r}")
        overrides = dict(overrides, experts_held=expert_share(overrides["experts_held"], cfg.n_routed_experts))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# safetensors dtype names -> torch types.
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors in their stored types, without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header of ``{name: {dtype, shape, data_offsets}}`` (offsets into the
    byte buffer that follows; ``__metadata__`` skipped), then the raw
    little-endian tensors. bfloat16 comes through ``torch.frombuffer``,
    which numpy cannot type."""
    with open(path, "rb") as f:
        (size,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(size))
        buf = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        if end > begin:
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=begin).clone()
        else:
            raw = torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(meta["shape"])
    return out


def load_hf_weights(path) -> dict[str, torch.Tensor]:
    """An HF checkpoint's weights, floating tensors as float32: a directory
    with ``model.safetensors``, a sharded ``model.safetensors.index.json``
    or ``pytorch_model.bin`` (looked for in that order), or one such file.
    ``.bin`` files load with ``torch.load(weights_only=True)``: tensors
    only, no code."""
    path = Path(path)

    def as_float(state: dict) -> dict:
        return {k: v.float() if v.is_floating_point() else v for k, v in state.items()}

    def load_bin(f):
        return as_float(torch.load(f, map_location="cpu", weights_only=True))

    if path.is_file():
        return as_float(read_safetensors(path)) if path.suffix == ".safetensors" else load_bin(path)
    if (path / "model.safetensors").exists():
        return as_float(read_safetensors(path / "model.safetensors"))
    index = path / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        out: dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(as_float(read_safetensors(path / shard)))
        return out
    if (path / "pytorch_model.bin").exists():
        return load_bin(path / "pytorch_model.bin")
    raise FileNotFoundError(
        f"No weights found under {path} (looked for model.safetensors, "
        "model.safetensors.index.json, pytorch_model.bin)"
    )


# ---------------------------------------------------------------------------
# A tokenizer for synthetic text
# ---------------------------------------------------------------------------


class HashTokenizer:
    """Deterministic whitespace + hash tokenizer for tests and synthetic text
    where no tokenizer file exists: [B, T] int32 ids and mask, BOS=0, PAD=1,
    EOS=2, word ids md5-hashed into [3, vocab). The JAX package's, id for id."""

    def __init__(self, vocab_size: int = 250002, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.pad, self.eos = 0, 1, 2

    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.lower().encode()).digest()[:4], "little")
        return 3 + h % (self.vocab_size - 3)

    def __call__(self, texts: list[str], max_length: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        T = max_length or self.max_length
        ids = np.full((len(texts), T), self.pad, dtype=np.int32)
        mask = np.zeros((len(texts), T), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.bos] + [self._tok(w) for w in text.split()][: T - 2] + [self.eos]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask
