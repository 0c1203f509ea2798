"""GEGLU feed-forward ``(h * gelu_tanh(g)) W_out^T + b_out`` with
``[h | g] = x W_in^T + b_in``: the wrapper of the CUDA kernel
(``csrc/geglu.cu``), its launch planner and its plain PyTorch version.

x is [C, D]; the weights are in ``nn.Linear`` layout (W_in [2F, D], b_in [2F],
W_out [D, F], b_out [D]), i.e. the transposes of the JAX ``fused_geglu``'s
kernels, all float32, bfloat16 or float16. Returns float32 [C, D]. Any
D >= 1 and F >= 1.

The call goes through ``GegluFunction``: the kernel forward, and a backward
in plain ops. The TPU kernel is forward-only and the JAX
package trains through the XLA feed-forward, whose gradient this is.
The two backwards differ in precision as the JAX package's do: this one
multiplies in x's type, as flax's ``Dense`` layers do, while the attention's
stays float32, as the JAX ``_bwd`` does (``ops/latent_attention.py``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SYMBOLS = {torch.float32: "geglu_f32", torch.bfloat16: "geglu_bf16", torch.float16: "geglu_f16"}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}

# Block tiles (rows, columns) of csrc/geglu.cu per type, by the index the
# plan gives: on the mma.sync route Large, then Small; float32's third is
# the warpgroup route's. In pass A a tile's columns are half h and half g.
# float16 takes bfloat16's tiles.
TILES = {
    torch.float32: ((128, 64), (64, 32), (128, 128)),
    torch.bfloat16: ((128, 128), (64, 32)),
    torch.float16: ((128, 128), (64, 32)),
}
WGMMA = 2  # float32's warpgroup tile in TILES
STAGE_BYTES = 64  # K depth of one mma.sync pipeline stage, in bytes of a tile row
WGMMA_STAGE = 32  # K depth of one warpgroup stage, in floats (128 bytes)
SCRATCH_LIMIT = 64 * 2**20  # u plus pass B's partials, per row chunk

# The warpgroup route takes float32 GEGLUs of at least this many rows (and D
# and F multiples of 4, 16-byte aligned operands); fewer rows stay on
# mma.sync's Small tiles, where reading the weights bounds the call and the
# route's split of the weights would cost more than it saves. Device times
# on an H100 (PERF.md, Findings), wgmma against mma.sync: D = 1,024, F = 4,096:
# C = 128 0.1196 ms against 0.1082; C = 192 0.1209 against 0.1630; D = 4,096,
# F = 16,384: C = 128 1.416 against 1.203; C = 256 1.681 against 2.298.
WGMMA_MIN_ROWS = 192
# The planner's model of a warpgroup chunk on an H100, in microseconds: one
# 128 x 128 tile's stage of 32 K (its 3xTF32 products; 1.1 measured in pass
# A at C = 4,096), a launch, and the split reduce's bytes a microsecond.
WG_STAGE_US, WG_LAUNCH_US, WG_BYTES_PER_US = 1.1, 4.0, 1.0e6


@dataclasses.dataclass(frozen=True)
class GegluPlan:
    """How ``geglu`` launches csrc/geglu.cu for one (C, D, F, dtype).

    C is walked ``chunk_rows`` rows at a time. Pass A covers a chunk with
    ``TILES[dtype][tile_a]`` tiles: tile (bx, by) owns rows bx*BM.. and gate
    columns by*BN/2.. (W_in rows f and F + f). Pass B covers [rows, D] with
    ``TILES[dtype][tile_b]`` tiles, each summing F columns
    [s*split_k, (s+1)*split_k) for split s < ``splits``. ``u_stride`` is the
    row stride of the u scratch, F rounded up to 8 elements (16-byte rows).
    ``route`` is "wgmma" (float32 on warpgroup MMA, persistent blocks, tile
    ``WGMMA`` in both passes) or "mma_sync" (one block a tile). The
    warpgroup route also holds both weights split into their big and small
    TF32 halves for the call: ``split_bytes`` (6·D·F floats; 0 on mma.sync).
    """

    chunk_rows: int
    u_stride: int
    tile_a: int
    tile_b: int
    splits: int
    split_k: int
    scratch_bytes: int
    route: str = "mma_sync"
    split_bytes: int = 0


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


def _wgmma_us(rows: int, d: int, f: int, splits: int, split_k: int, sms: int) -> float:
    """The planner's time of one chunk on the warpgroup route: each pass's
    units in waves of one a SM, times its stages of K; the launches; the
    split reduce's reads and writes."""
    bm, bn = TILES[torch.float32][WGMMA]
    row_tiles = -(-rows // bm)
    waves_a = -(-row_tiles * -(-f // (bn // 2)) // sms)
    waves_b = -(-row_tiles * -(-d // bn) * splits // sms)
    stages = waves_a * -(-d // WGMMA_STAGE) + waves_b * (split_k // WGMMA_STAGE)
    reduce = (splits > 1) * ((splits + 1) * rows * d * 4 / WG_BYTES_PER_US + WG_LAUNCH_US)
    return stages * WG_STAGE_US + 2 * WG_LAUNCH_US + reduce


def _plan_wgmma(c: int, d: int, f: int, sms: int) -> GegluPlan | None:
    """The warpgroup route's plan: of the row chunks (from the fewest the
    scratch allows to twice as many) and the splits of pass B's F sum (1 to
    8, whole stages) whose u and partials fit ``SCRATCH_LIMIT``, the one
    ``_wgmma_us`` gives the least time over all of C, among those that give
    each pass a unit per SM where any does. None if none fits."""
    bm, bn = TILES[torch.float32][WGMMA]
    u_stride = -(-f // 8) * 8
    fewest = -(-c * u_stride * 4 // SCRATCH_LIMIT)
    best = None
    for chunks in range(fewest, 2 * fewest + 1):
        rows = -(-c // chunks)
        n = -(-c // rows)
        last = c - (n - 1) * rows
        for want in range(1, 9):
            split_k = -(-(-(-f // want)) // WGMMA_STAGE) * WGMMA_STAGE
            splits = -(-f // split_k)
            scratch = rows * u_stride * 4 + (splits > 1) * splits * rows * d * 4
            if scratch > SCRATCH_LIMIT:
                continue
            row_tiles = -(-rows // bm)
            fills = min(row_tiles * -(-f // (bn // 2)), row_tiles * -(-d // bn) * splits) >= sms
            us = (n - 1) * _wgmma_us(rows, d, f, splits, split_k, sms) + _wgmma_us(
                last, d, f, splits, split_k, sms
            )
            if best is None or (not fills, us) < best[0]:
                plan = GegluPlan(
                    rows, u_stride, WGMMA, WGMMA, splits, split_k, scratch, "wgmma", 24 * d * f
                )
                best = ((not fills, us), plan)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=4096)
def plan_geglu(
    c: int, d: int, f: int, dtype: torch.dtype, sms: int, l2_bytes: int, aligned: bool = True
) -> GegluPlan:
    """Chunk rows, tiles, splits and scratch for C rows on a card with
    ``sms`` SMs and an L2 cache of ``l2_bytes``; ``aligned`` says that x,
    W_in and W_out start on 16-byte boundaries. float32 with at least
    ``WGMMA_MIN_ROWS`` rows, D and F multiples of 4 and aligned operands
    takes the warpgroup route (``_plan_wgmma``). Otherwise, on mma.sync,
    pass B's F sum splits until about two blocks per SM run (a single
    request has one row tile) and one split's columns of u and W_out fit in
    L2. Either way no split is empty, and the u scratch plus the partials
    stay within ``SCRATCH_LIMIT``. The rules follow times measured on an
    H100 (PERF.md, Findings). Plans are kept per shape: the search costs
    tens of microseconds of host time, as much as a small call's kernels."""
    if min(c, d, f) < 1:
        raise ValueError(f"geglu: needs C, D, F >= 1, got C={c} D={d} F={f}")
    if dtype == torch.float32 and aligned and c >= WGMMA_MIN_ROWS and d % 4 == 0 and f % 4 == 0:
        plan = _plan_wgmma(c, d, f, sms)
        if plan is not None:
            return plan
    es = _ELEMENT_BYTES[dtype]
    depth = STAGE_BYTES // es
    u_stride = -(-f // 8) * 8
    chunks = -(-c * u_stride * es // SCRATCH_LIMIT)
    while True:
        rows = -(-c // chunks)
        tile_a = _tile_a(TILES[dtype][:2], rows, f, sms)
        tile_b = _tile_b(TILES[dtype][:2], rows)
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_in, w_out))
    p = plan_geglu(c, d, f, x.dtype, props.multi_processor_count, props.L2_cache_size, aligned)
    u = torch.empty(p.chunk_rows * p.u_stride, dtype=x.dtype, device=x.device)
    partial = (
        torch.empty(p.splits * p.chunk_rows * d, dtype=torch.float32, device=x.device)
        if p.splits > 1
        else None
    )
    pointers = (
        *(t.data_ptr() for t in tensors), y.data_ptr(), u.data_ptr(),
        None if partial is None else partial.data_ptr(),
    )
    where = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if p.route == "wgmma":
        w_split = torch.empty(p.split_bytes // 4, dtype=torch.float32, device=x.device)
        fn = _build.function("geglu", "geglu_f32_wgmma", _WGMMA_ARGTYPES)
        code = fn(
            *pointers, w_split.data_ptr(), c, d, f, p.chunk_rows, p.u_stride, p.splits, p.split_k,
            *where,
        )
    else:
        fn = _build.function("geglu", _SYMBOLS[x.dtype], _ARGTYPES)
        code = fn(
            *pointers, c, d, f, p.chunk_rows, p.u_stride, p.tile_a, p.tile_b, p.splits, p.split_k,
            *where,
        )
    _build.check("geglu", code)
    geglu.launches += 1
    geglu.shapes[(c, d, f)] += 1
    geglu.routes[(p.route, x.dtype)] += 1
    profiling.count(f"geglu.rows_{p.route}", c)
    return y


def geglu_backward(x, w_in, b_in, w_out, b_out, grad):
    """The gradients (dx, dW_in, db_in, dW_out, db_out), each in its
    parameter's type. ``[h | g]`` is recomputed (a [C, 2F] block, 2 GB in
    float32 at the training step's C = 65,536 and D = 1024, freed here), the
    tanh-GELU gate differentiated, then both linears. The five products take
    their operands in x's type (float32 sums, as the flax ``Dense`` backward
    of the JAX package's FFN runs in its compute type); the gate's
    derivative and the bias sums stay float32. Float32 inputs give float32
    products throughout."""
    f = w_out.shape[-1]
    cdt = x.dtype
    w_in_c, w_out_c, dy = w_in.to(cdt), w_out.to(cdt), grad.to(cdt)
    hg = F.linear(x, w_in_c, b_in.to(cdt)).float()
    h, g = hg[:, :f], hg[:, f:]
    gate = F.gelu(g, approximate="tanh")
    u = (h * gate).to(cdt)  # the forward's rounding, straight through
    d_w_out = dy.T @ u
    del u
    du = (dy @ w_out_c).float()
    d_hg = torch.empty_like(hg)
    torch.mul(du, gate, out=d_hg[:, :f])
    del gate
    d_hg[:, f:] = torch.ops.aten.gelu_backward(du.mul_(h), g, approximate="tanh")
    del hg, h, g, du
    d_b_in = d_hg.sum(0)
    d_hg = d_hg.to(cdt)
    dx = d_hg @ w_in_c
    d_w_in = d_hg.T @ x
    return (
        dx, d_w_in.to(w_in.dtype), d_b_in.to(b_in.dtype),
        d_w_out.to(w_out.dtype), grad.float().sum(0).to(b_out.dtype),
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
    launches, ``geglu.shapes`` counts them by (C, D, F) and ``geglu.routes``
    by (route, dtype); in a traced unit the counters ``geglu.rows_wgmma``
    and ``geglu.rows_mma_sync`` sum the rows each route took."""
    return GegluFunction.apply(x, w_in, b_in, w_out, b_out)


geglu.launches = 0
geglu.shapes = collections.Counter()
geglu.routes = collections.Counter()
