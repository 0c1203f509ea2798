"""The transformer user tower in plain float32 PyTorch (the reference
repository's ``src/news_rec_utils/attention.py:210-272``, one layer).

A post-norm block over a user's padded history: 8-head self-attention with
QKV packed in one biased projection, the padding keys masked by adding the
float32 minimum to the logits; dropout, residual, LayerNorm; a gated MLP
(``down(gelu_tanh(gate) * up)``, ``[up, gate] = W x`` without bias, a fixed
intermediate width of 3,072), dropout inside it and after it, residual,
LayerNorm (epsilon 1e-12). The readout weighs each dimension by
``exp(W1 h + b1)`` over the history's real tokens, with no maximum taken
off, and sums. Dropout (rate 0.1 in training) keeps a value where a uniform
draw is below 0.9 and divides the kept ones by 0.9; its draws are
``DropoutStream``'s.
"""

from __future__ import annotations

import torch

from .common import Precision, gelu_tanh, layer_norm

TOKEN_LOCAL = False
LN_EPS = 1e-12
INTERMEDIATE = 3072


def param_shapes(tower: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Name -> (shape, init kind) of every parameter."""
    d = tower["reduced_dim"]
    out = {}
    for i in range(tower["num_layers"]):
        p = f"encoder.layer.{i}."
        out.update(
            {
                p + "attention.qkv_proj.weight": ((3 * d, d), "linear"),
                p + "attention.qkv_proj.bias": ((3 * d,), "bias"),
                p + "attention.o_proj.weight": ((d, d), "linear"),
                p + "attention.o_proj.bias": ((d,), "bias"),
                p + "attn_layernorm.weight": ((d,), "norm_weight"),
                p + "attn_layernorm.bias": ((d,), "bias"),
                p + "g_mlp.up_gate_proj.weight": ((2 * INTERMEDIATE, d), "linear"),
                p + "g_mlp.down_proj.weight": ((d, INTERMEDIATE), "linear"),
                p + "g_mlp.down_proj.bias": ((d,), "bias"),
                p + "g_mlp_layernorm.weight": ((d,), "norm_weight"),
                p + "g_mlp_layernorm.bias": ((d,), "bias"),
            }
        )
    out["linear1.weight"] = ((d, d), "linear")
    out["linear1.bias"] = ((d,), "bias")
    return out


class DropoutStream:
    """Dropout masks drawn from ``generator``: each call draws uniforms over
    ``[rows, L, width]`` (the whole padded batch, ``rows`` of them) and
    keeps the first ``U`` rows."""

    def __init__(self, generator: torch.Generator, rows: int, rate: float):
        self.generator, self.rows, self.rate = generator, rows, rate

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        u, length, width = x.shape
        draw = torch.rand((self.rows, length, width), generator=self.generator, device=x.device)[:u]
        keep = 1.0 - self.rate
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def users_padded(p: dict, tower: dict, x: torch.Tensor, mask: torch.Tensor, prec: Precision, dropout=None):
    """[U, L, D] left-justified rows (pad positions zero), [U, L] mask ->
    [U, D] user vectors."""
    drop = dropout or (lambda t: t)
    heads = tower["num_heads"]
    u, length, d = x.shape
    m = mask.float()
    h = x
    for i in range(tower["num_layers"]):
        p_ = f"encoder.layer.{i}."
        qkv = prec.linear(h, p[p_ + "attention.qkv_proj.weight"], p[p_ + "attention.qkv_proj.bias"])
        q, k, v = (t.reshape(u, length, heads, d // heads).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        logits = prec.einsum("bhld,bhmd->bhlm", q, k) * (d // heads) ** -0.5
        bias = (1.0 - m[:, None, None, :]) * torch.finfo(torch.float32).min
        probs = torch.softmax(logits + bias, dim=-1)
        ctx = prec.einsum("bhlm,bhmd->bhld", probs, v).transpose(1, 2).reshape(u, length, d)
        attn = drop(prec.linear(ctx, p[p_ + "attention.o_proj.weight"], p[p_ + "attention.o_proj.bias"])) + h
        attn = layer_norm(attn, p[p_ + "attn_layernorm.weight"], p[p_ + "attn_layernorm.bias"], LN_EPS)
        up, gate = prec.linear(attn, p[p_ + "g_mlp.up_gate_proj.weight"]).chunk(2, dim=-1)
        gated = drop(gelu_tanh(gate) * up)
        mlp = drop(prec.linear(gated, p[p_ + "g_mlp.down_proj.weight"], p[p_ + "g_mlp.down_proj.bias"])) + attn
        h = layer_norm(mlp, p[p_ + "g_mlp_layernorm.weight"], p[p_ + "g_mlp_layernorm.bias"], LN_EPS)
    w = torch.exp(prec.linear(h, p["linear1.weight"], p["linear1.bias"])) * m[..., None]
    w = w / (w.sum(dim=1, keepdim=True) + 1e-10)
    return (h * w).sum(dim=1)


def forward_flops(tower: dict, tokens: float, sq_tokens: float = 0.0, calls: int = 1) -> float:
    """Model FLOPs of the forward over ``tokens`` real tokens whose rows'
    squared lengths sum to ``sq_tokens``: per token the QKV, output, MLP and
    readout products; per pair of real tokens in a row the logits and the
    weighted sum."""
    del calls
    d, layers = tower["reduced_dim"], tower["num_layers"]
    per_token = layers * (2.0 * d * 3 * d + 2.0 * d * d + 2.0 * d * 2 * INTERMEDIATE + 2.0 * INTERMEDIATE * d)
    per_token += 2.0 * d * d
    return float(tokens) * per_token + layers * 4.0 * d * float(sq_tokens)
