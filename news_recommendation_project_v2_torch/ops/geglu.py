"""GEGLU feed-forward ``(h * gelu_tanh(g)) W_out^T + b_out`` with
``[h | g] = x W_in^T + b_in``: the wrapper of the CUDA kernel
(``csrc/geglu.cu``) and its plain PyTorch version.

x is [C, D]; the weights are in ``nn.Linear`` layout (W_in [2F, D], b_in [2F],
W_out [D, F], b_out [D]), i.e. the transposes of the JAX ``fused_geglu``'s
kernels. Returns float32 [C, D].
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "geglu_f32", torch.bfloat16: "geglu_bf16"}
# Tile sizes of csrc/geglu.cu: tokens per block and F columns per chunk.
_ROWS, _COLS = 16, 128
_MAX_D = 1024


def reference_geglu(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The plain version, in the kernel's arithmetic: float32 products, bias
    and tanh-GELU gate; the gated product rounded to x's type before W_out."""
    hg = F.linear(x.float(), w_in.float(), b_in.float())
    h, g = hg.chunk(2, dim=-1)
    u = (h * F.gelu(g, approximate="tanh")).to(x.dtype).float()
    return F.linear(u, w_out.float(), b_out.float())


def _splits(c: int, f: int, device: torch.device) -> int:
    """How many blocks share one token tile's F loop: enough that a small C
    still gives about two blocks per SM, and no split is left empty."""
    tiles = -(-c // _ROWS)
    chunks = -(-f // _COLS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(chunks, max(1, -(-2 * sms // tiles)))
    per = -(-chunks // want)
    return -(-chunks // per)


def geglu(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``geglu.launches`` counts the kernel launches and
    ``geglu.shapes`` counts them by (C, D, F)."""
    tensors = (x, w_in, b_in, w_out, b_out)
    if _build.on_cpu(tensors):
        return reference_geglu(*tensors)
    _build.validate("geglu", tensors)
    c, d = x.shape
    f = w_out.shape[-1]
    want = [(c, d), (2 * f, d), (2 * f,), (d, f), (d,)]
    if [tuple(t.shape) for t in tensors] != want:
        raise ValueError(
            f"geglu: shapes {[tuple(t.shape) for t in tensors]} are not "
            f"x [C,D], w_in [2F,D], b_in [2F], w_out [D,F], b_out [D]"
        )
    if d > _MAX_D:
        raise ValueError(f"geglu: the kernel holds rows of at most {_MAX_D}, got D={d}")
    y = torch.empty((c, d), dtype=torch.float32, device=x.device)
    if c == 0:
        return y
    splits = _splits(c, f, x.device)
    partial = (
        torch.empty((splits, c, d), dtype=torch.float32, device=x.device)
        if splits > 1
        else None
    )
    fn = _build.function("geglu", _SYMBOLS[x.dtype], _ARGTYPES)
    code = fn(
        *(t.data_ptr() for t in tensors), y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        c, d, f, splits, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("geglu", code)
    geglu.launches += 1
    geglu.shapes[(c, d, f)] += 1
    return y


geglu.launches = 0
geglu.shapes = collections.Counter()
