"""Kimi Delta Attention's recurrence, the core of a KDA layer: the wrapper of
the chunked kernel (``csrc/kda.cu``), its plain PyTorch version and the
per-token recurrence it stands for.

Per row and head, with S_0 = 0 at the row's start (k and q already
L2-normalised, q already scaled):

    S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

Shapes: q, k [B, T, H, Dk] and v [B, T, H, Dv] in the compute type,
``log_alpha`` [B, T, H, Dk] float32 (log alpha, at most 0: a decay a
channel), ``beta`` [B, T, H] float32; ``lens`` [B] int32 the rows' real
lengths (right padding; ``None``: T). o comes back [B, T, H, Dv] in q's
type, 0 at positions past a row's length. The state is float32 throughout.

Both versions take chunks of ``CHUNK`` tokens. Inside a chunk, with G_t the
cumulative log-decay from the chunk's start through token t (a vector over
the channels) and S the state at the chunk's start:

    A[t, j] = beta_t sum_c k_t[c] k_j[c] exp(G_t[c] - G_j[c])   (j < t)
    P[t, j] =        sum_c q_t[c] k_j[c] exp(G_t[c] - G_j[c])   (j <= t)
    (I + A) W_k = Diag(beta) (exp(G) * K),  (I + A) W_v = Diag(beta) V
    U = W_v - W_k S
    O = (exp(G) * Q) S + P U
    S <- Diag(exp(G_last)) S + (exp(G_last - G) * K)^T U

Every exponent is a decay from a later token back to an earlier one, so it
is at most 0: a chunk whose log-decays sum to -1,000 underflows to 0 where
the true factor is that small, and nothing overflows (a factored form
exp(G_t) exp(-G_j) would overflow at -89). On the card one launch computes
a whole batch (``kda.launches`` counts them); on the CPU the plain version
loops over the chunks.

The layer's elementwise work around the recurrence has two kernels of its
own beside it (same library), each with its plain version: ``kda_prep``
(the short convs, SiLU, the L2 norms and q's scale, the per-channel decay)
and ``kda_gated_norm`` (the output's per-head RMSNorm times the sigmoid
gate). Both compute in float32 from the compute type's values and round
their outputs once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

CHUNK = 16
HEAD_DIM = 128  # the kernel's Dk = Dv
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_PREP_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_NORM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
L2_EPS = 1e-6


def recurrent_kda(q, k, v, log_alpha, beta) -> torch.Tensor:
    """The recurrence one token at a time, float32 [B, T, H, Dv] (pads
    computed like any token)."""
    b, t, h, dk = q.shape
    s = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32, device=q.device)
    out = torch.empty(b, t, h, v.shape[-1], dtype=torch.float32, device=q.device)
    for i in range(t):
        kt = k[:, i].float()
        s = s * log_alpha[:, i].float().exp()[..., None]
        u = beta[:, i, :, None].float() * (v[:, i].float() - torch.einsum("bhk,bhkv->bhv", kt, s))
        s = s + kt[..., None] * u[..., None, :]
        out[:, i] = torch.einsum("bhk,bhkv->bhv", q[:, i].float(), s)
    return out


def reference_kda(q, k, v, log_alpha, beta, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain chunked version, float32 throughout, o in q's type."""
    b, t, h, dk = q.shape
    dv, c = v.shape[-1], CHUNK
    n = -(-t // c)
    pad = n * c - t

    def chunks(x: torch.Tensor) -> torch.Tensor:  # [B, T, H, X] -> [B, H, n, C, X] float32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.view(b, n, c, h, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    gc = chunks(log_alpha).cumsum(-2)
    bc = chunks(beta[..., None])[..., 0]
    lower = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    strict = lower & ~torch.eye(c, dtype=torch.bool, device=q.device)
    eye = torch.eye(c, device=q.device)
    s = torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
    out = torch.empty(b, h, n, c, dv, dtype=torch.float32, device=q.device)
    for i in range(n):
        g, kk, qq, vv, bb = gc[:, :, i], kc[:, :, i], qc[:, :, i], vc[:, :, i], bc[:, :, i]
        diff = (g[:, :, :, None, :] - g[:, :, None, :, :]).masked_fill(~lower[:, :, None], float("-inf"))
        kj = kk[:, :, None, :, :] * diff.exp()  # [B, H, t, j, Dk]: k_j decayed to t
        a = torch.einsum("bhic,bhijc->bhij", kk, kj) * bb[..., None] * strict
        p = torch.einsum("bhic,bhijc->bhij", qq, kj)
        rhs = torch.cat([kk * g.exp(), vv], dim=-1) * bb[..., None]
        w = torch.linalg.solve_triangular(eye + a, rhs, upper=False, unitriangular=True)
        wk, wv = w.split([dk, dv], dim=-1)
        u = wv - wk @ s
        out[:, :, i] = (qq * g.exp()) @ s + p @ u
        last = g[:, :, -1:, :]
        s = last.transpose(-1, -2).exp() * s + (kk * (last - g).exp()).transpose(-1, -2) @ u
    o = out.permute(0, 2, 3, 1, 4).reshape(b, n * c, h, dv)[:, :t]
    if lens is not None:
        o = o * (torch.arange(t, device=q.device)[None, :] < lens.to(q.device).long()[:, None])[:, :, None, None]
    return o.to(q.dtype)


def _check(q, k, v, log_alpha, beta, lens) -> None:
    b, t, h, dk = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kda: the kernel takes bfloat16 q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dk != HEAD_DIM or tuple(k.shape) != (b, t, h, dk) or tuple(v.shape) != (b, t, h, HEAD_DIM):
        raise ValueError(f"kda: q, k, v must be [B, T, H, {HEAD_DIM}], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if log_alpha.dtype != torch.float32 or tuple(log_alpha.shape) != (b, t, h, dk):
        raise ValueError("kda: log_alpha must be float32 [B, T, H, Dk]")
    if beta.dtype != torch.float32 or tuple(beta.shape) != (b, t, h):
        raise ValueError("kda: beta must be float32 [B, T, H]")
    if lens is not None and (lens.dtype != torch.int32 or tuple(lens.shape) != (b,)):
        raise ValueError("kda: lens must be int32 [B]")
    tensors = [q, k, v, log_alpha, beta] + ([] if lens is None else [lens])
    if not all(x.is_cuda and x.device == q.device and x.is_contiguous() for x in tensors):
        raise ValueError("kda: inputs must be contiguous on one CUDA device")
    if any(x.requires_grad for x in tensors) and torch.is_grad_enabled():
        raise RuntimeError("kda: the kernel is forward-only")


def kda(q, k, v, log_alpha, beta, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (bfloat16 q, k, v of 128 a head) or raise. Forward only."""
    tensors = (q, k, v, log_alpha, beta) + (() if lens is None else (lens,))
    if _build.on_cpu(tensors):
        return reference_kda(q, k, v, log_alpha, beta, lens)
    _check(q, k, v, log_alpha, beta, lens)
    b, t, h, _ = q.shape
    o = torch.empty_like(v)
    if b and t and h:
        fn = _build.function("kda", "kda_chunked_bf16", _ARGTYPES)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_alpha.data_ptr(), beta.data_ptr(),
            None if lens is None else lens.data_ptr(), o.data_ptr(), b, t, h, q.device.index, stream,
        )
        _build.check("kda", code)
        kda.launches += 1
    return o


kda.launches = 0


def _short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv of [B, T, C] rows, float32:
    out[t] = sum_s weight[:, 0, K - 1 - s] x[t - s], zero before a row's start."""
    xf, w = x.float(), weight.float()[:, 0]
    k = w.shape[-1]
    out = xf * w[:, k - 1]
    for s in range(1, k):
        out[:, s:] += xf[:, :-s] * w[:, k - 1 - s]
    return F.silu(out)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """``x / sqrt(sum(x^2) + 1e-6)`` over the last axis."""
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def reference_kda_prep(q_lin, k_lin, v_lin, f, convs, a_log, dt_bias, heads: int, scale: float):
    """The plain version of ``kda_prep``: from the projections [B, T, H·d]
    (and ``f``, the decay's projection), q, k and v [B, T, H, d] in the
    projections' type and log alpha [B, T, H, d] float32."""
    b, t, inner = q_lin.shape
    shape = (b, t, heads, inner // heads)
    q, k, v = (_short_conv(x, w).view(shape) for x, w in zip((q_lin, k_lin, v_lin), convs))
    dt = q_lin.dtype
    q = (l2norm(q) * scale).to(dt)
    k = l2norm(k).to(dt)
    log_alpha = -a_log.float().exp()[:, None] * F.softplus(f.float().view(shape) + dt_bias.float().view(shape[2:]))
    return q, k, v.to(dt), log_alpha


def kda_prep(q_lin, k_lin, v_lin, f, convs, a_log, dt_bias, heads: int, scale: float):
    """q, k, v (SiLU of the short convs; q and k L2-normalised per head, q
    times ``scale``) and log alpha = -exp(``a_log``[h]) softplus(f +
    ``dt_bias``): the plain version on the CPU, one launch on the card
    (bfloat16 projections, heads of 128)."""
    tensors = (q_lin, k_lin, v_lin, f)
    if _build.on_cpu(tensors):
        return reference_kda_prep(q_lin, k_lin, v_lin, f, convs, a_log, dt_bias, heads, scale)
    b, t, inner = q_lin.shape
    if q_lin.dtype != torch.bfloat16 or inner != heads * HEAD_DIM or any(
        x.dtype != torch.bfloat16 or tuple(x.shape) != (b, t, inner) or not x.is_contiguous() for x in tensors
    ):
        raise ValueError(f"kda_prep: the kernel takes contiguous bfloat16 [B, T, H x {HEAD_DIM}] projections")
    w = [c.float().reshape(inner, -1).contiguous() for c in convs]
    if any(x.shape[1] != 4 for x in w):
        raise ValueError("kda_prep: the kernel takes convs of width 4")
    a, bias = a_log.float().contiguous(), dt_bias.float().contiguous()
    q, k, v = (torch.empty(b, t, heads, HEAD_DIM, dtype=torch.bfloat16, device=q_lin.device) for _ in range(3))
    log_alpha = torch.empty(b, t, heads, HEAD_DIM, dtype=torch.float32, device=q_lin.device)
    if b and t:
        fn = _build.function("kda", "kda_prep_bf16", _PREP_ARGTYPES)
        code = fn(
            q_lin.data_ptr(), k_lin.data_ptr(), v_lin.data_ptr(), f.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
            w[2].data_ptr(), a.data_ptr(), bias.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            log_alpha.data_ptr(), b, t, heads, float(scale), q_lin.device.index,
            torch.cuda.current_stream(q_lin.device).cuda_stream,
        )
        _build.check("kda", code)
    return q, k, v, log_alpha


def reference_gated_norm(o, gate, weight, eps: float) -> torch.Tensor:
    """The plain version of ``kda_gated_norm``: [B, T, H·d] in o's type."""
    b, t, h, d = o.shape
    of = o.float()
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps) * weight.float()
    return (y.reshape(b, t, h * d) * torch.sigmoid(gate.float())).to(o.dtype)


def kda_gated_norm(o, gate, weight, eps: float) -> torch.Tensor:
    """o [B, T, H, d] RMSNorm'd per head (``weight`` [d]) times
    sigmoid(``gate`` [B, T, H·d]): the plain version on the CPU, one launch
    on the card (bfloat16, heads of 128)."""
    if _build.on_cpu((o, gate)):
        return reference_gated_norm(o, gate, weight, eps)
    b, t, h, d = o.shape
    if o.dtype != torch.bfloat16 or gate.dtype != o.dtype or d != HEAD_DIM or tuple(gate.shape) != (b, t, h * d) \
            or not (o.is_contiguous() and gate.is_contiguous()):
        raise ValueError(f"kda_gated_norm: the kernel takes contiguous bfloat16 o [B, T, H, {HEAD_DIM}] and gate")
    w = weight.float().contiguous()
    out = torch.empty(b, t, h * d, dtype=o.dtype, device=o.device)
    if b and t:
        fn = _build.function("kda", "kda_gated_norm_bf16", _NORM_ARGTYPES)
        code = fn(o.data_ptr(), gate.data_ptr(), w.data_ptr(), out.data_ptr(), b * t, h, float(eps),
                  o.device.index, torch.cuda.current_stream(o.device).cuda_stream)
        _build.check("kda", code)
    return out
