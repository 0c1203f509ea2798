"""Latent cross-attention ``softmax(q k^T / sqrt(dh)) v``: the wrapper of the
CUDA kernel (``csrc/latent_attention.cu``) and its plain PyTorch version.

Layouts as in the JAX package's ``fused_latent_attention``: q [B, H, L, dh]
history queries; k, v [H, N, dh] latent keys and values shared by every batch
row. Returns [B, H, L, dh] in q's type.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "latent_attention_f32", torch.bfloat16: "latent_attention_bf16"}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version: float32 logits, softmax and products, as the kernel
    computes them, then the output in q's type."""
    dh = q.shape[-1]
    logits = torch.einsum("bhld,hnd->bhln", q.float(), k.float()) * dh**-0.5
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhln,hnd->bhld", probs, v.float()).to(q.dtype)


def latent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``latent_attention.launches`` counts the kernel launches and
    ``latent_attention.shapes`` counts them by (B, H, L, N, dh)."""
    if _build.on_cpu((q, k, v)):
        return reference_attention(q, k, v)
    _build.validate("latent_attention", (q, k, v))
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"latent_attention: want q [B,H,L,dh], k = v [H,N,dh]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, l, dh = q.shape
    n = k.shape[1]
    if k.shape != (h, n, dh) or not (0 < h <= 65535 and b <= 65535 and n > 0):
        raise ValueError(
            f"latent_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("latent_attention", _SYMBOLS[q.dtype], _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, l, n, dh, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("latent_attention", code)
    latent_attention.launches += 1
    latent_attention.shapes[(b, h, l, n, dh)] += 1
    return out


latent_attention.launches = 0
latent_attention.shapes = collections.Counter()
