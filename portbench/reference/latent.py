"""The latent-attention user tower in plain float32 PyTorch (NV-Embed's
latent pooling, arXiv 2405.17428; the reference repository's
``src/news_rec_utils/latent_attention.py:77-171``).

Each history token x is the query of a pre-norm cross-attention over the
``num_latents`` learned latents (8 heads of 512, scaled dot product,
softmax over the latents, no mask, no bias), added to x; then a pre-norm
GEGLU feed-forward (``W2 (h * gelu_tanh(g)) + b2`` with ``[h, g] = W1 x +
b1``, hidden 4 x D), added again; LayerNorm epsilon 1e-6. A user vector is
the mean of its row's token states, L2-normalised. A token's state depends
on that token alone, so rows may be fed as one flat token stream.

Parameter names are the reference module's ``state_dict`` names.
"""

from __future__ import annotations

import torch

from .common import Precision, gelu_tanh, layer_norm

TOKEN_LOCAL = True
LN_EPS = 1e-6


def param_shapes(tower: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Name -> (shape, init kind) of every parameter."""
    d, f = tower["reduced_dim"], tower["hidden_dim"]
    inner = tower["num_heads"] * tower["latent_dim_head"]
    a, g = "cross_attend_blocks.0.", "cross_attend_blocks.1."
    return {
        "latents": ((tower["num_latents"], d), "normal"),
        a + "fn.to_q.weight": ((inner, d), "linear"),
        a + "fn.to_kv.weight": ((2 * inner, d), "linear"),
        a + "fn.to_out.weight": ((d, inner), "linear"),
        a + "norm.weight": ((d,), "norm_weight"),
        a + "norm.bias": ((d,), "bias"),
        a + "norm_context.weight": ((d,), "norm_weight"),
        a + "norm_context.bias": ((d,), "bias"),
        g + "fn.net.0.weight": ((2 * f, d), "linear"),
        g + "fn.net.0.bias": ((2 * f,), "bias"),
        g + "fn.net.2.weight": ((d, f), "linear"),
        g + "fn.net.2.bias": ((d,), "bias"),
        g + "norm.weight": ((d,), "norm_weight"),
        g + "norm.bias": ((d,), "bias"),
    }


def token_states(p: dict, tower: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[T, D] history tokens -> [T, D] token states."""
    a, g = "cross_attend_blocks.0.", "cross_attend_blocks.1."
    heads, dh = tower["num_heads"], tower["latent_dim_head"]
    t, n = x.shape[0], p["latents"].shape[0]
    ctx = layer_norm(p["latents"], p[a + "norm_context.weight"], p[a + "norm_context.bias"], LN_EPS)
    k, v = prec.linear(ctx, p[a + "fn.to_kv.weight"]).chunk(2, dim=-1)
    k, v = k.reshape(n, heads, dh), v.reshape(n, heads, dh)
    q = prec.linear(layer_norm(x, p[a + "norm.weight"], p[a + "norm.bias"], LN_EPS), p[a + "fn.to_q.weight"])
    logits = prec.einsum("thd,nhd->thn", q.reshape(t, heads, dh), k) * dh**-0.5
    o = prec.einsum("thn,nhd->thd", torch.softmax(logits, dim=-1), v).reshape(t, heads * dh)
    h = x + prec.linear(o, p[a + "fn.to_out.weight"])
    hn = layer_norm(h, p[g + "norm.weight"], p[g + "norm.bias"], LN_EPS)
    hh, gate = prec.linear(hn, p[g + "fn.net.0.weight"], p[g + "fn.net.0.bias"]).chunk(2, dim=-1)
    return h + prec.linear(hh * gelu_tanh(gate), p[g + "fn.net.2.weight"], p[g + "fn.net.2.bias"])


def users_flat(p: dict, tower: dict, tokens: torch.Tensor, lens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[T, D] tokens of rows laid end to end, [U] lengths -> [U, D] user
    vectors (a row of length 0 stays zero)."""
    states = token_states(p, tower, tokens, prec)
    rows = torch.repeat_interleave(torch.arange(len(lens), device=tokens.device), lens.long())
    sums = torch.zeros(len(lens), states.shape[1], device=tokens.device).index_add(0, rows, states)
    mean = sums / lens.float().clamp_min(1.0)[:, None]
    return mean / torch.sqrt((mean * mean).sum(-1, keepdim=True) + 1e-12)


def users_padded(p: dict, tower: dict, x: torch.Tensor, mask: torch.Tensor, prec: Precision, dropout=None):
    """[U, L, D] left-justified rows, [U, L] mask -> [U, D] user vectors.
    The tower has no dropout, so ``dropout`` is not used."""
    del dropout
    lens = mask.sum(1).long()
    return users_flat(p, tower, x[mask.bool()], lens, prec)


def forward_flops(tower: dict, tokens: float, sq_tokens: float = 0.0, calls: int = 1) -> float:
    """Model FLOPs of the forward over ``tokens`` real tokens in ``calls``
    tower calls: per token the q, output and GEGLU products and the
    attention's two over the latents; per call the latents' k and v.
    ``sq_tokens`` (the sum of squared row lengths) does not enter: no token
    attends to another."""
    del sq_tokens
    d, f, n = tower["reduced_dim"], tower["hidden_dim"], tower["num_latents"]
    inner = tower["num_heads"] * tower["latent_dim_head"]
    per_token = 2.0 * d * inner * 2 + 4.0 * n * inner + 2.0 * d * 2 * f + 2.0 * f * d
    return float(tokens) * per_token + calls * 2.0 * n * d * 2 * inner
