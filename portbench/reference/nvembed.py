"""NV-Embed-v2 in plain float32 PyTorch: the news encoder of the
``nvembed2-latent4096`` configuration (arXiv 2405.17428;
https://huggingface.co/nvidia/NV-Embed-v2, its ``config.json``).

The backbone is Mistral-7B's decoder with the causal mask removed: token
embeddings; per layer a pre-norm (RMSNorm) grouped-query self-attention
(32 query heads over 8 key-value heads of 128, rotate-half rotary positions
at theta 10^4, a padding-only mask) and a pre-norm SwiGLU MLP
(``down(silu(gate x) * up x)``), each added to the residual stream; a final
RMSNorm. The pooling head is the latent attention: every token is the query
of a pre-norm cross-attention over 512 learned latents (8 heads of 4,096,
softmax over the latents, no mask, no bias), added to the token; then a
pre-norm GEGLU feed-forward (4,096 -> 2 x 16,384 -> 4,096), added again; the
mean of the tokens that the pool mask keeps; the L2 norm.

Departures, each where this file and the program agree against the source:

- the weights are bfloat16 values (the configuration's precision), read
  here as float32; NV-Embed ships them in float32 and the reference
  repository ran them in float16;
- the GEGLU's gate is GELU's tanh form (the port's kernel, the JAX
  package); NV-Embed's code calls the exact ``F.gelu``;
- the head's LayerNorms take epsilon 1e-6 (flax's, as the user tower);
  NV-Embed's ``nn.LayerNorm`` takes torch's 1e-5;
- the pool leaves out BOS and every token of the instruction, as the paper
  says ("mask out the instruction tokens"); NV-Embed's code clears the
  first ``len(tokenize(instruction))`` positions, BOS among them, which
  keeps the instruction's last token in the mean.

Parameter names are the port's ``NewsEncoder`` ``state_dict`` names. No
import of the port, its kernels or JAX: every product is a plain ``torch``
operation through ``Products``, which can round its operands (the controls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import gelu_tanh, layer_norm, round_mantissa

LN_EPS = 1e-6  # the head's LayerNorms
FF_MULT = 4  # the head's GEGLU: hidden 4 x D


def widths(hf: dict) -> dict:
    """The sizes of an NV-Embed ``config.json`` (its ``text_config`` and
    ``latent_attention_config``) under short names."""
    t, lat = hf["text_config"], hf["latent_attention_config"]
    heads = t["num_attention_heads"]
    return {
        "vocab": t["vocab_size"], "d": t["hidden_size"], "layers": t["num_hidden_layers"], "heads": heads,
        "kv": t.get("num_key_value_heads", heads), "hd": t.get("head_dim") or t["hidden_size"] // heads,
        "ffn": t["intermediate_size"], "eps": t.get("rms_norm_eps", 1e-5), "theta": t.get("rope_theta", 10000.0),
        "latents": lat["num_latents_value"], "pool_heads": lat["num_cross_heads"], "pool_dh": lat["cross_dim_head"],
    }


def param_shapes(hf: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Name -> (shape, init kind) of every parameter, in the port's order."""
    w = widths(hf)
    d, hd, f = w["d"], w["hd"], w["ffn"]
    out = {"embed_tokens.weight": ((w["vocab"], d), "normal")}
    for i in range(w["layers"]):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": ((d,), "norm_weight"),
            p + "self_attn.q_proj.weight": ((w["heads"] * hd, d), "linear"),
            p + "self_attn.k_proj.weight": ((w["kv"] * hd, d), "linear"),
            p + "self_attn.v_proj.weight": ((w["kv"] * hd, d), "linear"),
            p + "self_attn.o_proj.weight": ((d, w["heads"] * hd), "linear"),
            p + "post_attention_layernorm.weight": ((d,), "norm_weight"),
            p + "mlp.gate_proj.weight": ((f, d), "linear"),
            p + "mlp.up_proj.weight": ((f, d), "linear"),
            p + "mlp.down_proj.weight": ((d, f), "linear"),
        })
    out["norm.weight"] = ((d,), "norm_weight")
    inner, hidden = w["pool_heads"] * w["pool_dh"], FF_MULT * d
    a, g = "latent_pool.cross_attend_blocks.0.", "latent_pool.cross_attend_blocks.1."
    out.update({
        "latent_pool.latents": ((w["latents"], d), "normal"),
        a + "fn.to_q.weight": ((inner, d), "linear"),
        a + "fn.to_kv.weight": ((2 * inner, d), "linear"),
        a + "fn.to_out.weight": ((d, inner), "linear"),
        a + "norm.weight": ((d,), "norm_weight"),
        a + "norm.bias": ((d,), "bias"),
        a + "norm_context.weight": ((d,), "norm_weight"),
        a + "norm_context.bias": ((d,), "bias"),
        g + "fn.net.0.weight": ((2 * hidden, d), "linear"),
        g + "fn.net.0.bias": ((2 * hidden,), "bias"),
        g + "fn.net.2.weight": ((d, hidden), "linear"),
        g + "fn.net.2.bias": ((d,), "bias"),
        g + "norm.weight": ((d,), "norm_weight"),
        g + "norm.bias": ((d,), "bias"),
    })
    return out


class Products:
    """The reference's matrix products in float32, each operand first rounded
    to ``bits`` mantissa bits (23: float32 as it is)."""

    def __init__(self, bits: int = 23):
        self.bits = bits

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return round_mantissa(x.float(), self.bits)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        y = F.linear(self._r(x), self._r(w))
        return y if b is None else y + b.float()

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._r(a), self._r(b))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rotary(t: int, hd: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half tables [T, hd]: the frequencies repeated twice."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def backbone(p: dict, w: dict, ids: torch.Tensor, mask: torch.Tensor, prod: Products, causal: bool = False,
             layers: int | None = None) -> torch.Tensor:
    """[B, T] ids and mask -> [B, T, D] float32 states after the final norm:
    ``layers`` of the layers (all), the padding mask alone unless
    ``causal``."""
    b, t = ids.shape
    h, kv, hd = w["heads"], w["kv"], w["hd"]
    x = p["embed_tokens.weight"][ids.long()].float()
    cos, sin = rotary(t, hd, w["theta"], ids.device)
    keep = mask[:, None, None, :].bool()
    if causal:
        keep = keep & torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
    bias = torch.zeros(keep.shape, device=ids.device).masked_fill(~keep, torch.finfo(torch.float32).min)
    for i in range(w["layers"] if layers is None else layers):
        pre = f"layers.{i}."
        y = rms_norm(x, p[pre + "input_layernorm.weight"], w["eps"])
        q = prod.linear(y, p[pre + "self_attn.q_proj.weight"]).view(b, t, h, hd).transpose(1, 2)
        k = prod.linear(y, p[pre + "self_attn.k_proj.weight"]).view(b, t, kv, hd).transpose(1, 2)
        v = prod.linear(y, p[pre + "self_attn.v_proj.weight"]).view(b, t, kv, hd).transpose(1, 2)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        k, v = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
        probs = torch.softmax(prod.matmul(q, k.transpose(-1, -2)) * hd**-0.5 + bias, dim=-1)
        ctx = prod.matmul(probs, v).transpose(1, 2).reshape(b, t, h * hd)
        x = x + prod.linear(ctx, p[pre + "self_attn.o_proj.weight"])
        y = rms_norm(x, p[pre + "post_attention_layernorm.weight"], w["eps"])
        gate = F.silu(prod.linear(y, p[pre + "mlp.gate_proj.weight"]))
        x = x + prod.linear(gate * prod.linear(y, p[pre + "mlp.up_proj.weight"]), p[pre + "mlp.down_proj.weight"])
    return rms_norm(x, p["norm.weight"], w["eps"])


def head(p: dict, w: dict, x: torch.Tensor, prod: Products) -> torch.Tensor:
    """[B, T, D] token states -> [B, T, D] after the latent cross-attention
    and the GEGLU, each added to its input."""
    a, g = "latent_pool.cross_attend_blocks.0.", "latent_pool.cross_attend_blocks.1."
    heads, dh = w["pool_heads"], w["pool_dh"]
    b, t, _ = x.shape
    n = p["latent_pool.latents"].shape[0]
    ctx = layer_norm(p["latent_pool.latents"].float(), p[a + "norm_context.weight"].float(),
                     p[a + "norm_context.bias"].float(), LN_EPS)
    k, v = prod.linear(ctx, p[a + "fn.to_kv.weight"]).chunk(2, dim=-1)
    k, v = k.reshape(n, heads, dh).transpose(0, 1), v.reshape(n, heads, dh).transpose(0, 1)
    xn = layer_norm(x, p[a + "norm.weight"].float(), p[a + "norm.bias"].float(), LN_EPS)
    q = prod.linear(xn, p[a + "fn.to_q.weight"]).view(b, t, heads, dh).transpose(1, 2)
    probs = torch.softmax(prod.matmul(q, k.transpose(-1, -2)) * dh**-0.5, dim=-1)
    o = prod.matmul(probs, v).transpose(1, 2).reshape(b, t, heads * dh)
    x = x + prod.linear(o, p[a + "fn.to_out.weight"])
    xn = layer_norm(x, p[g + "norm.weight"].float(), p[g + "norm.bias"].float(), LN_EPS)
    hh, gate = prod.linear(xn, p[g + "fn.net.0.weight"], p[g + "fn.net.0.bias"]).chunk(2, dim=-1)
    return x + prod.linear(hh * gelu_tanh(gate), p[g + "fn.net.2.weight"], p[g + "fn.net.2.bias"])


@torch.no_grad()
def encode(p: dict, hf: dict, ids: torch.Tensor, mask: torch.Tensor, pool_mask: torch.Tensor | None = None,
           prod: Products | None = None, causal: bool = False, layers: int | None = None,
           latent_head: bool = True) -> torch.Tensor:
    """[B, T] ids, mask and pool mask (``None``: ``mask``) -> [B, D] unit
    vectors. ``prod``, ``causal``, ``layers`` and ``latent_head=False`` (the
    masked mean of the backbone's states, no head) are the controls'."""
    w = widths(hf)
    prod = prod or Products()
    x = backbone(p, w, ids, mask, prod, causal, layers)
    if latent_head:
        x = head(p, w, x, prod)
    m = (mask if pool_mask is None else pool_mask).float()
    mean = (x * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
    return mean / torch.sqrt((mean * mean).sum(-1, keepdim=True) + 1e-12)


def forward_flops(hf: dict, lens, calls: int = 0) -> float:
    """Model FLOPs of the encoder over rows of ``lens`` real tokens: per
    token the backbone's and the head's products, per row the
    self-attention's two products over its own length in every layer, per
    head call (``calls``) the latents' keys and values. Padding is not
    counted."""
    w = widths(hf)
    d, hd, inner = w["d"], w["hd"], w["pool_heads"] * w["pool_dh"]
    tokens = float(sum(int(x) for x in lens))
    squares = float(sum(int(x) ** 2 for x in lens))
    layer = 2.0 * d * hd * (2 * w["heads"] + 2 * w["kv"]) + 6.0 * d * w["ffn"]
    pooled = 4.0 * d * inner + 4.0 * w["latents"] * inner + 2.0 * d * 2 * FF_MULT * d + 2.0 * FF_MULT * d * d
    attention = 4.0 * w["heads"] * hd * w["layers"]
    return tokens * (w["layers"] * layer + pooled) + squares * attention + calls * 4.0 * w["latents"] * d * inner
