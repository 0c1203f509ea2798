"""GEGLU feed-forward ``(h * gelu_tanh(g)) W_out^T + b_out`` with
``[h | g] = x W_in^T + b_in``: the wrapper of the CUDA kernel
(``csrc/geglu.cu``), its launch planner and its plain PyTorch version.

x is [C, D]; the weights are in ``nn.Linear`` layout (W_in [2F, D], b_in [2F],
W_out [D, F], b_out [D]), i.e. the transposes of the JAX ``fused_geglu``'s
kernels. Returns float32 [C, D]. Any D >= 1 and F >= 1.

The call goes through ``GegluFunction``: the kernel forward, and a backward
in plain ops. The TPU kernel is forward-only and the JAX
package trains through the XLA feed-forward, whose gradient this is.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "geglu_f32", torch.bfloat16: "geglu_bf16"}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# Block tiles (rows, columns) of csrc/geglu.cu per type, by the index the
# kernel takes: Large, then Small. In pass A a tile's columns are half h and
# half g.
TILES = {torch.float32: ((128, 64), (64, 32)), torch.bfloat16: ((128, 128), (64, 32))}
STAGE_BYTES = 64  # K depth of one pipeline stage, in bytes of a tile row
SCRATCH_LIMIT = 64 * 2**20  # u plus pass B's partials, per row chunk


@dataclasses.dataclass(frozen=True)
class GegluPlan:
    """How ``geglu`` launches csrc/geglu.cu for one (C, D, F, dtype).

    C is walked ``chunk_rows`` rows at a time. Pass A covers a chunk with
    ``TILES[dtype][tile_a]`` blocks: block (bx, by) owns rows bx*BM.. and gate
    columns by*BN/2.. (W_in rows f and F + f). Pass B covers [rows, D] with
    ``TILES[dtype][tile_b]`` blocks, each summing F columns
    [s*split_k, (s+1)*split_k) for split s < ``splits``. ``u_stride`` is the
    row stride of the u scratch, F rounded up to 8 elements (16-byte rows).
    """

    chunk_rows: int
    u_stride: int
    tile_a: int
    tile_b: int
    splits: int
    split_k: int
    scratch_bytes: int


def _tile_a(tiles, rows: int, f: int, sms: int) -> int:
    """Pass A's tile: the largest whose rows the chunk fills and that still
    gives a block per SM (else the smallest), since its K (= D) cannot
    split."""
    for i, (bm, bn) in enumerate(tiles):
        if bm <= rows and -(-rows // bm) * -(-f // (bn // 2)) >= sms:
            return i
    return len(tiles) - 1


def _tile_b(tiles, rows: int) -> int:
    """Pass B's tile: the largest whose rows the chunk fills (else the
    smallest); splitting its F sum then fills the card."""
    return next((i for i, (bm, _) in enumerate(tiles) if bm <= rows), len(tiles) - 1)


def plan_geglu(
    c: int, d: int, f: int, dtype: torch.dtype, sms: int, l2_bytes: int
) -> GegluPlan:
    """Chunk rows, tiles, splits and scratch for C rows on a card with
    ``sms`` SMs and an L2 cache of ``l2_bytes``. Pass B's F sum splits until
    about two blocks per SM run (a single request has one row tile) and one
    split's columns of u and W_out fit in L2; no split is empty, and the u
    scratch plus the partials stay within ``SCRATCH_LIMIT``. The rules
    follow times measured on an H100 (PERF.md, Findings)."""
    if min(c, d, f) < 1:
        raise ValueError(f"geglu: needs C, D, F >= 1, got C={c} D={d} F={f}")
    es = _ELEMENT_BYTES[dtype]
    depth = STAGE_BYTES // es
    u_stride = -(-f // 8) * 8
    chunks = -(-c * u_stride * es // SCRATCH_LIMIT)
    while True:
        rows = -(-c // chunks)
        tile_a = _tile_a(TILES[dtype], rows, f, sms)
        tile_b = _tile_b(TILES[dtype], rows)
        bm, bn = TILES[dtype][tile_b]
        blocks = -(-rows // bm) * -(-d // bn)
        fill = max(1, int(2 * sms / blocks + 0.5))
        fit = -(-(rows + d) * f * es // l2_bytes)
        want = min(-(-f // depth), max(fill, fit))
        split_k = -(-(-(-f // want)) // depth) * depth
        splits = -(-f // split_k)
        scratch = rows * u_stride * es + (splits > 1) * splits * rows * d * 4
        if scratch <= SCRATCH_LIMIT:
            return GegluPlan(rows, u_stride, tile_a, tile_b, splits, split_k, scratch)
        if rows == 1:
            raise ValueError(f"geglu: one row of F={f} needs more than {SCRATCH_LIMIT} bytes")
        chunks += 1


def reference_geglu(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The plain version, in the kernel's arithmetic: float32 products, bias
    and tanh-GELU gate; the gated product rounded to x's type before W_out."""
    hg = F.linear(x.float(), w_in.float(), b_in.float())
    h, g = hg.chunk(2, dim=-1)
    u = (h * F.gelu(g, approximate="tanh")).to(x.dtype).float()
    return F.linear(u, w_out.float(), b_out.float())


def _forward(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Counts the launches on ``geglu``."""
    tensors = (x, w_in, b_in, w_out, b_out)
    if _build.on_cpu(tensors):
        return reference_geglu(*tensors)
    _build.validate("geglu", tensors)
    c, d = x.shape
    f = w_out.shape[-1]
    want = [(c, d), (2 * f, d), (2 * f,), (d, f), (d,)]
    if [tuple(t.shape) for t in tensors] != want or min(d, f) < 1:
        raise ValueError(
            f"geglu: shapes {[tuple(t.shape) for t in tensors]} are not "
            f"x [C,D], w_in [2F,D], b_in [2F], w_out [D,F], b_out [D] with D, F >= 1"
        )
    y = torch.empty((c, d), dtype=torch.float32, device=x.device)
    if c == 0:
        return y
    props = torch.cuda.get_device_properties(x.device)
    p = plan_geglu(c, d, f, x.dtype, props.multi_processor_count, props.L2_cache_size)
    u = torch.empty(p.chunk_rows * p.u_stride, dtype=x.dtype, device=x.device)
    partial = (
        torch.empty(p.splits * p.chunk_rows * d, dtype=torch.float32, device=x.device)
        if p.splits > 1
        else None
    )
    fn = _build.function("geglu", _SYMBOLS[x.dtype], _ARGTYPES)
    code = fn(
        *(t.data_ptr() for t in tensors), y.data_ptr(), u.data_ptr(),
        None if partial is None else partial.data_ptr(),
        c, d, f, p.chunk_rows, p.u_stride, p.tile_a, p.tile_b, p.splits, p.split_k,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("geglu", code)
    geglu.launches += 1
    geglu.shapes[(c, d, f)] += 1
    return y


def geglu_backward(x, w_in, b_in, w_out, b_out, grad):
    """The gradients (dx, dW_in, db_in, dW_out, db_out) of the plain
    version, in float32: ``[h | g]`` is recomputed (a [C, 2F] block, 2 GB at
    the training step's C = 65,536 and D = 1024, freed here), the tanh-GELU
    gate differentiated, then both linears."""
    f = w_out.shape[-1]
    x32, w_in32, w_out32, dy = x.float(), w_in.float(), w_out.float(), grad.float()
    hg = F.linear(x32, w_in32, b_in.float())
    h, g = hg[:, :f], hg[:, f:]
    gate = F.gelu(g, approximate="tanh")
    u = (h * gate).to(x.dtype).float()  # the forward's rounding, straight through
    d_w_out = dy.T @ u
    del u
    du = dy @ w_out32
    d_hg = torch.empty_like(hg)
    torch.mul(du, gate, out=d_hg[:, :f])
    del gate
    d_hg[:, f:] = torch.ops.aten.gelu_backward(du.mul_(h), g, approximate="tanh")
    del hg, h, g, du
    dx = d_hg @ w_in32
    d_w_in = d_hg.T @ x32
    d_b_in = d_hg.sum(0)
    return (
        dx.to(x.dtype), d_w_in.to(w_in.dtype), d_b_in.to(b_in.dtype),
        d_w_out.to(w_out.dtype), dy.sum(0).to(b_out.dtype),
    )


class GegluFunction(torch.autograd.Function):
    """``geglu`` with a backward: the forward is the kernel on CUDA (its
    plain version on the CPU), run with grad mode off as every ``Function``
    forward is; the backward is ``geglu_backward`` in plain ops."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out):
        ctx.save_for_backward(x, w_in, b_in, w_out, b_out)
        return _forward(x, w_in, b_in, w_out, b_out)

    @staticmethod
    def backward(ctx, grad):
        return geglu_backward(*ctx.saved_tensors, grad)


def geglu(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The call goes through ``GegluFunction``, which records a graph
    only where autograd records. ``geglu.launches`` counts the kernel
    launches and ``geglu.shapes`` counts them by (C, D, F)."""
    return GegluFunction.apply(x, w_in, b_in, w_out, b_out)


geglu.launches = 0
geglu.shapes = collections.Counter()
