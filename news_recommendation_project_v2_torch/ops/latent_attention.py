"""Latent cross-attention ``softmax(q k^T / sqrt(dh)) v``: the wrapper of the
CUDA kernel (``csrc/latent_attention.cu``), its launch planner and its plain
PyTorch version.

Layouts as in the JAX package's ``fused_latent_attention``: q [B, H, L, dh]
history queries; k, v [H, N, dh] latent keys and values shared by every batch
row. Returns [B, H, L, dh] in q's type. Any N <= 1024 and dh <= 1024.

The call goes through ``LatentAttentionFunction``: the kernel forward, and the JAX package's plain backward (``pallas_attention.py::_bwd``;
the TPU kernel has no backward kernel either).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "latent_attention_f32", torch.bfloat16: "latent_attention_bf16"}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# csrc/latent_attention.cu's block shapes by their rows (Large, Medium,
# Pair, Small): the warps that split a logits stage's dh and a P.V stage's
# columns, the latents of a P.V stage, the warps of a block and the blocks
# an SM holds. Then the constants its shared memory is laid out by. The CUDA
# source exports its own layout (``kernel_smem``); a card test holds
# ``attention_smem`` to it for every block shape, N and type.
SHAPES = {128: (1, 32, 4, 2), 64: (1, 32, 4, 3), 32: (4, 16, 8, 1), 16: (4, 16, 4, 2)}
ROWS = tuple(SHAPES)
SLICE_COLS = 16  # a slice of dh is a whole number of these columns
MAX_N = MAX_DH = 1024
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
_STAGES, _TILE_N, _PAD_N = 4, 64, 32


def attention_smem(rows: int, n: int, dtype: torch.dtype) -> int:
    """Shared memory of a block of ``rows`` folded rows: the cp.async ring
    (each slot a logits stage of q and k rows, or a P.V stage of V rows), the
    float32 logits [rows, N] with a padded stride, a scratch area (the warps'
    partial logits where several warps split dh, then each warp's 8 staged
    output rows) and the rows' offsets in o."""
    es = _ELEMENT_BYTES[dtype]
    warps_k, depth_v, warps, _ = SHAPES[rows]
    logits_stage = (rows + _TILE_N) * (64 * warps_k + 16)
    v_stage = depth_v * (_TILE_N * warps_k * es + (32 if es == 4 else 16))
    scratch = max(warps_k * rows * _TILE_N if warps_k > 1 else 0, warps * 8 * (_TILE_N + 8))
    p_rows = rows * (-(-n // _PAD_N) * _PAD_N + 4)
    return _STAGES * max(logits_stage, v_stage) + (p_rows + scratch) * 4 + rows * 8


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How ``latent_attention`` launches csrc/latent_attention.cu.

    For each head the B*L query rows fold into one dimension M. Block
    (bx, h, s) owns folded rows bx*rows.. and dh columns
    [s*slice_cols, min(dh, (s+1)*slice_cols)); the grid is
    (ceil(M / rows), H, slices)."""

    rows: int
    slices: int
    slice_cols: int
    smem_bytes: int
    blocks: int


def plan_attention(
    b: int, h: int, l: int, n: int, dh: int, dtype: torch.dtype, sms: int
) -> AttentionPlan:
    """Block shape and slices of dh for a card with ``sms`` SMs, by rules
    that follow times measured on an H100 (PERF.md, Findings):

    * Large (128 rows) where its row tiles fill the card 8 times over (the
      flat eval): fewest re-reads of K and V, tails negligible;
    * else Medium (64 rows) where its row tiles fill the card once;
    * else Pair (32 rows, 8 warps) where its tiles reach a quarter of the
      SMs, else Small (16 rows). These two split each stage's dh over 4
      warps, so a block's chain of stages is short; dh then splits into S
      slices, no narrower than their 256-column P.V tile and no more than
      one wave of blocks holds. Each slice recomputes its tile's logits and
      re-reads K from L2, so at a few rows more blocks do not run faster:
      the chain of stages in a block, not the number of SMs, sets the time.

    A shape whose shared memory exceeds what a block may use is passed over
    (large N falls to Small). Raises ``ValueError`` past N or dh of 1024."""
    if min(b, h, l) < 1:
        raise ValueError(f"latent_attention: needs B, H, L >= 1, got B={b} H={h} L={l}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"latent_attention: N={n} latents is past the kernel's limit of 1 to {MAX_N}")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"latent_attention: dh={dh} is past the kernel's limit of 1 to {MAX_DH}")
    m = b * l
    want = {128: 8 * sms, 64: sms, 32: -(-sms // 4), 16: 0}
    rows = next(
        r for r in ROWS
        if attention_smem(r, n, dtype) <= SMEM_LIMIT and -(-m // r) * h >= want[r]
    )
    tiles = -(-m // rows) * h
    steps = -(-dh // SLICE_COLS)
    warps_k, _, _, per_sm = SHAPES[rows]
    slices = 1
    if warps_k > 1:
        slices = max(1, min(-(-dh // (_TILE_N * warps_k)), per_sm * sms // tiles))
    slice_cols = -(-steps // slices) * SLICE_COLS
    slices = -(-dh // slice_cols)
    return AttentionPlan(rows, slices, slice_cols, attention_smem(rows, n, dtype), tiles * slices)


# A serving call takes tens of microseconds on the card, so the wrapper's
# host work is kept short: the plan is cached per shape, the SM count per
# device and the loaded launcher per type, and the stream handle is read
# without building a Stream object.
_plan = functools.lru_cache(maxsize=1024)(plan_attention)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher(dtype: torch.dtype):
    return _build.function("latent_attention", _SYMBOLS[dtype], _ARGTYPES)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version: float32 logits, softmax and products, as the kernel
    computes them, then the output in q's type."""
    dh = q.shape[-1]
    logits = torch.einsum("bhld,hnd->bhln", q.float(), k.float()) * dh**-0.5
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhln,hnd->bhld", probs, v.float()).to(q.dtype)


def _launch(q, k, v, out, rows: int, slices: int, slice_cols: int) -> None:
    """The kernel into ``out`` under the plan (rows, slices, slice_cols), on
    q's device and its current stream; raises if the launcher refuses. The
    wrapper checks the tensors first; the plan sweep and the card tests call
    it with plans of their own."""
    b, h, l, dh = q.shape
    index = q.get_device()
    code = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, l, k.shape[1], dh, rows, slices, slice_cols, index,
        torch._C._cuda_getCurrentRawStream(index),  # the current stream's handle
    )
    _build.check("latent_attention", code)


def kernel_smem(rows: int, n: int, dtype: torch.dtype) -> int:
    """Shared memory of a block of ``rows`` rows as the CUDA source lays it
    out (-1: no such block shape), to hold ``attention_smem`` to it on the
    card."""
    fn = _build.function("latent_attention", "latent_attention_smem", [ctypes.c_int] * 3)
    return fn(rows, n, int(dtype == torch.bfloat16))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Counts the launches on ``latent_attention``."""
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
    p = _plan(b, h, l, n, dh, q.dtype, _sm_count(q.get_device()))
    _launch(q, k, v, out, p.rows, p.slices, p.slice_cols)
    latent_attention.launches += 1
    latent_attention.shapes[(b, h, l, n, dh)] += 1
    return out


def attention_backward(q, k, v, grad):
    """The gradients (dq, dk, dv) of ``softmax(q k^T / sqrt(dh)) v`` as the
    JAX package's ``_bwd`` computes them: the probabilities recomputed in
    float32, then einsums. k and v are shared by every batch row, so dk and
    dv sum over B and L."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, grad))
    probs = torch.softmax(torch.einsum("bhld,hnd->bhln", q32, k32) * scale, dim=-1)
    dprobs = torch.einsum("bhld,hnd->bhln", g32, v32)
    dlogits = probs * (dprobs - (probs * dprobs).sum(-1, keepdim=True))
    del dprobs
    dv = torch.einsum("bhln,bhld->hnd", probs, g32)
    del probs
    dq = torch.einsum("bhln,hnd->bhld", dlogits, k32) * scale
    dk = torch.einsum("bhln,bhld->hnd", dlogits, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class LatentAttentionFunction(torch.autograd.Function):
    """``latent_attention`` with a backward: the forward is the kernel on
    CUDA (its plain version on the CPU), run with grad mode off as every
    ``Function`` forward is; the backward is ``attention_backward`` in plain
    ops."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        return attention_backward(*ctx.saved_tensors, grad)


def latent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The call goes through ``LatentAttentionFunction``, which records
    a graph only where autograd records. ``latent_attention.launches`` counts
    the kernel launches and ``latent_attention.shapes`` counts them by
    (B, H, L, N, dh)."""
    return LatentAttentionFunction.apply(q, k, v)


latent_attention.launches = 0
latent_attention.shapes = collections.Counter()
