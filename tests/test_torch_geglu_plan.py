"""The GEGLU kernel's launch planner (``ops/geglu.py::plan_geglu``) and the
wrapper's any-D contract, on the CPU.

The planner decides how csrc/geglu.cu covers a GEGLU: the route (float32 on
warpgroup MMA, or mma.sync), row chunks, the tile of each pass and pass B's
split of the F sum. Its invariants are held here at the serving, fixed,
flat-eval, training and NV-Embed tower shapes, for an H100's 132 SMs: every
row, every [h | g] column and every output column covered exactly once, no
empty split, the scratch within its limit, enough blocks to fill the card,
and the route rule."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.ops.pallas_geglu import (
    reference_geglu as jax_reference_geglu,
)
from news_recommendation_project_v2_torch.ops.geglu import (
    SCRATCH_LIMIT,
    STAGE_BYTES,
    TILES,
    WGMMA,
    WGMMA_MIN_ROWS,
    WGMMA_STAGE,
    geglu,
    plan_geglu,
)
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.utils.memory import geglu_scratch_bytes
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SMS, L2 = 132, 50 * 2**20  # an H100 SXM
SHAPES = [
    (1, 64, 4),
    (37, 1024, 4096),
    (300, 96, 130),
    (4800, 1024, 4096),
    (131072, 1024, 4096),
    (37, 1536, 6144),
    (4096, 1024, 4096),  # the flat eval's row chunk
    (4100, 1024, 4096),  # a ragged one
    (65536, 1024, 4096),  # flat training
    (262144, 1024, 4096),  # the flat eval's token chunk
    (1024, 4096, 16384),  # the NV-Embed tower's row chunk
    (65536, 4096, 16384),  # its flat eval's token chunk
]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _ceil(a, b):
    return -(-a // b)


def _chunks(c, plan):
    return [(r0, min(plan.chunk_rows, c - r0)) for r0 in range(0, c, plan.chunk_rows)]


def _covered_once(ranges, n):
    """True when the half-open ranges cover 0..n-1 each exactly once."""
    count = collections.Counter()
    for lo, hi in ranges:
        assert lo < hi, "an empty range"
        count.update(range(lo, hi))
    return count == collections.Counter(range(n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_row_and_column_once(shape, dtype):
    c, d, f = shape
    plan = plan_geglu(c, d, f, dtype, SMS, L2)
    chunks = _chunks(c, plan)
    assert _covered_once([(r0, r0 + rows) for r0, rows in chunks], c)
    for tile in (plan.tile_a, plan.tile_b):
        bm, _ = TILES[dtype][tile]
        for _, rows in chunks:
            assert _covered_once(
                [(bx * bm, min(rows, (bx + 1) * bm)) for bx in range(_ceil(rows, bm))], rows
            )
    # pass A: block column by holds gate columns f of h (W_in row f) and g (F + f)
    half = TILES[dtype][plan.tile_a][1] // 2
    gate = [(by * half, min(f, (by + 1) * half)) for by in range(_ceil(f, half))]
    assert _covered_once(gate + [(f + lo, f + hi) for lo, hi in gate], 2 * f)
    # pass B: output columns, and the F sum of every output tile
    bn = TILES[dtype][plan.tile_b][1]
    assert _covered_once([(by * bn, min(d, (by + 1) * bn)) for by in range(_ceil(d, bn))], d)
    splits = [(s * plan.split_k, min(f, (s + 1) * plan.split_k)) for s in range(plan.splits)]
    assert _covered_once(splits, f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_splits_are_nonempty_whole_stages(shape, dtype):
    """Every split of pass B's F sum holds at least one column, and starts on
    a pipeline stage, as the kernel requires (it checks split_k too)."""
    c, d, f = shape
    plan = plan_geglu(c, d, f, dtype, SMS, L2)
    depth = STAGE_BYTES // torch.tensor([], dtype=dtype).element_size()
    if plan.route == "wgmma":
        depth = WGMMA_STAGE
    assert plan.split_k % depth == 0
    assert plan.splits == _ceil(f, plan.split_k)
    assert (plan.splits - 1) * plan.split_k < f


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_scratch_within_limit(shape, dtype):
    """u [chunk_rows, u_stride] in x's type plus the float32 partials stay
    within 64 MB at any C (the flat eval runs C = 131,072); u rows are
    16-byte aligned for cp.async."""
    c, d, f = shape
    plan = plan_geglu(c, d, f, dtype, SMS, L2)
    es = torch.tensor([], dtype=dtype).element_size()
    assert plan.u_stride >= f and plan.u_stride % 8 == 0
    partial = plan.splits * plan.chunk_rows * d * 4 if plan.splits > 1 else 0
    assert plan.scratch_bytes == plan.chunk_rows * plan.u_stride * es + partial
    assert plan.scratch_bytes <= SCRATCH_LIMIT == 64 * 2**20


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] >= 4096])
def test_plan_fills_the_card(shape, dtype):
    """At full width, a single request (C=37) included, each pass launches
    at least one block per SM."""
    c, d, f = shape
    plan = plan_geglu(c, d, f, dtype, SMS, L2)
    rows = plan.chunk_rows
    bm, bn = TILES[dtype][plan.tile_a]
    assert _ceil(rows, bm) * _ceil(f, bn // 2) >= SMS
    bm, bn = TILES[dtype][plan.tile_b]
    assert _ceil(rows, bm) * _ceil(d, bn) * plan.splits >= SMS


@pytest.mark.parametrize(
    "dtype, shape, aligned, route",
    [
        (torch.float32, (4096, 1024, 4096), True, "wgmma"),
        (torch.float32, (WGMMA_MIN_ROWS, 1024, 4096), True, "wgmma"),
        (torch.float32, (1024, 4096, 16384), True, "wgmma"),
        (torch.float32, (WGMMA_MIN_ROWS - 1, 1024, 4096), True, "mma_sync"),
        (torch.float32, (37, 1024, 4096), True, "mma_sync"),
        (torch.float32, (4096, 1024, 4096), False, "mma_sync"),
        (torch.float32, (4096, 1022, 4096), True, "mma_sync"),
        (torch.float32, (4096, 1024, 4094), True, "mma_sync"),
        (torch.bfloat16, (4096, 1024, 4096), True, "mma_sync"),
        (torch.float16, (4096, 1024, 4096), True, "mma_sync"),
        (torch.bfloat16, (1024, 4096, 16384), True, "mma_sync"),
        (torch.float16, (1024, 4096, 16384), True, "mma_sync"),
    ],
)
def test_plan_route_rule(dtype, shape, aligned, route):
    """float32 with at least WGMMA_MIN_ROWS rows, D and F multiples of 4 and
    16-byte aligned operands takes the warpgroup route, on its own tile in
    both passes; fewer rows, ragged widths, unaligned operands and the
    16-bit types take mma.sync on its Large and Small tiles."""
    plan = plan_geglu(*shape, dtype, SMS, L2, aligned)
    assert plan.route == route
    if route == "wgmma":
        assert plan.tile_a == plan.tile_b == WGMMA
    else:
        assert {plan.tile_a, plan.tile_b} <= {0, 1}


@pytest.mark.parametrize(
    "d, compute, c",
    [(1024, "float32", 262144), (1024, "float32", 37), (4096, "float32", 65536), (1024, "bfloat16", 524288)],
)
def test_plan_scratch_is_counted_in_the_memory_model(d, compute, c):
    """What a call of the tower's GEGLU allocates beside its output (u, the
    partials and, on the warpgroup route, the weights' TF32 halves) is
    within ``utils.memory.geglu_scratch_bytes``, at the flat evals' chunks
    and one request."""
    dtype = getattr(torch, compute)
    plan = plan_geglu(c, d, 4 * d, dtype, SMS, L2)
    assert plan.split_bytes == (2 * 3 * d * 4 * d * 4 if plan.route == "wgmma" else 0)
    assert plan.scratch_bytes + plan.split_bytes <= geglu_scratch_bytes(
        TowerConfig(reduced_dim=d, compute_dtype=compute)
    )


@pytest.mark.parametrize("shape", [(3, 8, 0), (0, 8, 4), (3, 0, 4)])
def test_plan_refuses_empty_shapes(shape):
    with pytest.raises(ValueError, match="needs C, D, F >= 1"):
        plan_geglu(*shape, torch.float32, SMS, L2)


def test_wrapper_takes_wide_d_on_cpu():
    """D = 1536 (wider than one 1024 row, the old kernel's limit): the
    wrapper on CPU tensors against the JAX reference, float32, within 1e-5."""
    c, d, f = 37, 1536, 6144
    rng = np.random.default_rng(0)
    x = rng.standard_normal((c, d)).astype(np.float32)
    w_in = (rng.standard_normal((d, 2 * f)) * d**-0.5).astype(np.float32)
    b_in = (rng.standard_normal(2 * f) * 0.02).astype(np.float32)
    w_out = (rng.standard_normal((f, d)) * f**-0.5).astype(np.float32)
    b_out = (rng.standard_normal(d) * 0.02).astype(np.float32)
    got = geglu(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w_in.T, b_in, w_out.T, b_out))
    ).numpy()
    want = np.asarray(jax_reference_geglu(*(jnp.asarray(a) for a in (x, w_in, b_in, w_out, b_out))))
    assert got.shape == (c, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
