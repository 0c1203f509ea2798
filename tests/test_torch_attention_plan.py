"""The attention kernel's launch planner (``ops/latent_attention.py::
plan_attention``) and the wrapper's limits, on the CPU.

The planner decides how csrc/latent_attention.cu covers an attention: the
rows of a block's tile over the folded B*L query rows of a head, and the
slices of dh. Its invariants are held here at the serving, fixed and
flat-eval shapes, for an H100's 132 SMs: every folded row and every dh column
covered exactly once, slices of whole 16-column steps, shared memory within
what a block may use, and the block shapes its measured rules pick."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.ops.pallas_attention import _reference_attention
from news_recommendation_project_v2_torch.ops.latent_attention import (
    MAX_DH,
    MAX_N,
    ROWS,
    SLICE_COLS,
    SMEM_LIMIT,
    attention_smem,
    latent_attention,
    plan_attention,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SMS = 132  # an H100 SXM
SHAPES = [  # (B, H, L, N, dh)
    (1, 8, 16, 64, 512),  # a single request
    (8, 8, 64, 64, 512),
    (3, 8, 37, 64, 512),  # ragged folded rows
    (4, 8, 300, 64, 512),
    (8, 8, 600, 64, 512),
    (1, 8, 131072, 64, 512),  # the flat eval
    (2, 3, 5, 70, 100),
    (1, 2, 20, 1024, 1024),
    (1, 8, 16, 512, 4096),  # NV-Embed's pooling head: one news
    (8, 8, 32, 512, 4096),
    (128, 8, 32, 512, 4096),
    (2, 3, 5, 70, 4000),
]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _ceil(a, b):
    return -(-a // b)


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
    """Row tiles cover the M = B*L folded rows of a head; slices cover dh.
    Each folded row maps to one (b, l) and back."""
    b, h, l, n, dh = shape
    p = plan_attention(b, h, l, n, dh, dtype, SMS)
    m = b * l
    assert p.rows in ROWS
    if m <= 4096:
        tiles = [(bx * p.rows, min(m, (bx + 1) * p.rows)) for bx in range(_ceil(m, p.rows))]
        assert _covered_once(tiles, m)
        assert sorted((r // l, r % l) for r in range(m)) == [(i, j) for i in range(b) for j in range(l)]
    cols = [(s * p.slice_cols, min(dh, (s + 1) * p.slice_cols)) for s in range(p.slices)]
    assert _covered_once(cols, dh)
    assert p.blocks == _ceil(m, p.rows) * h * p.slices


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_slices_are_whole_nonempty_steps(shape, dtype):
    """Every slice starts on a 16-column step (so its rows stay 16-byte
    aligned for cp.async) and holds at least one column."""
    b, h, l, n, dh = shape
    p = plan_attention(b, h, l, n, dh, dtype, SMS)
    assert p.slice_cols >= SLICE_COLS and p.slice_cols % SLICE_COLS == 0
    assert p.slices == _ceil(dh, p.slice_cols)
    assert (p.slices - 1) * p.slice_cols < dh


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 64, 70, 700, 1024])
@pytest.mark.parametrize("dh", [1, 100, 512, 1024, 2048, 4096])
def test_plan_shared_memory_fits(n, dh, dtype):
    """At every N and dh up to the limits, in both types, the block the
    planner picks needs at most the 232,448 bytes a block may use."""
    for b, l in ((1, 16), (8, 600)):
        p = plan_attention(b, 8, l, n, dh, dtype, SMS)
        assert p.smem_bytes == attention_smem(p.rows, n, dtype) <= SMEM_LIMIT == 232_448


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_for_one_request_splits_within_one_wave(dtype):
    """A single request (B=1, L=16) takes the 16-row block and splits dh into
    slices of one 256-column P.V tile each; all blocks fit one wave (two an
    SM). More, narrower slices would re-read K without shortening the
    block's chain of stages."""
    p = plan_attention(1, 8, 16, 64, 512, dtype, SMS)
    assert (p.rows, p.slices, p.slice_cols) == (16, 2, 256)
    assert p.blocks <= 2 * SMS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "bl, rows, slices",
    [((1, 16), 16, 2), ((1, 128), 16, 2), ((1, 256), 32, 2), ((8, 64), 32, 1), ((4, 300), 64, 1),
     ((8, 600), 64, 1), ((1, 131072), 128, 1)],
)
def test_plan_shape_follows_the_rows(bl, rows, slices, dtype):
    """At H=8, dh=512: Small, then Pair, Medium and Large blocks as the folded
    rows grow, as measured fastest on an H100 (PERF.md, Findings)."""
    p = plan_attention(bl[0], 8, bl[1], 64, 512, dtype, SMS)
    assert (p.rows, p.slices) == (rows, slices)


@pytest.mark.parametrize("n", [64, 1024])
def test_plan_passes_over_shapes_that_do_not_fit(n):
    """At N=1024 only the 16-row block's logits fit in shared memory, so even
    the flat eval takes it; at N=64 every shape fits."""
    fits = [r for r in ROWS if attention_smem(r, n, torch.float32) <= SMEM_LIMIT]
    assert fits == ([16] if n == 1024 else list(ROWS))
    assert plan_attention(1, 8, 131072, n, 512, torch.float32, SMS).rows == max(fits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_does_not_split_the_flat_eval(dtype):
    """At the flat eval's [1, 8, 131072, 512] the row tiles alone fill the
    card many times over: the largest block and no slices, so no logit is
    computed twice."""
    p = plan_attention(1, 8, 131072, 64, 512, dtype, SMS)
    assert (p.rows, p.slices, p.slice_cols) == (max(ROWS), 1, 512)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "bl, rows, slices", [((1, 16), 16, 16), ((1, 4), 16, 16), ((8, 32), 32, 2), ((32, 32), 32, 1), ((128, 32), 32, 1)]
)
def test_plan_at_the_encoder_head(bl, rows, slices, dtype):
    """NV-Embed's head (N = 512, dh = 4,096): float32 logits rows of 2 KB take
    Large out of shared memory and leave one Medium block an SM, so the rows
    fall to Pair and Small, as measured fastest on an H100 (``plan_sweep
    encoder``: Pair 8% ahead of Medium at 4,096 folded rows); one news
    splits dh 16 ways within one wave."""
    assert attention_smem(128, 512, dtype) > SMEM_LIMIT >= attention_smem(64, 512, dtype) > SMEM_LIMIT // 2
    p = plan_attention(bl[0], 8, bl[1], 512, 4096, dtype, SMS)
    assert (p.rows, p.slices) == (rows, slices) and p.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bl", [(1592, 32), (776, 64), (368, 128), (8, 32)])
def test_plan_at_the_encoder_head_in_16_bits(bl, dtype):
    """The head computing in the encoder's 16-bit type, at the encode's
    batches (the memory model's at widths 32, 64 and 128 on an 80 GB card,
    and a bucket's last few rows): Pair blocks, whose 16-bit P.V stages and
    float32 logits rows fit a block's shared memory with room for none
    beside it, one slice of dh where the rows fill the card."""
    p = plan_attention(bl[0], 8, bl[1], 512, 4096, dtype, SMS)
    assert p.rows == 32 and p.smem_bytes == attention_smem(32, 512, dtype) <= SMEM_LIMIT < 2 * p.smem_bytes
    assert p.slices == (1 if bl[0] * bl[1] >= 4096 else 2) and p.slices * p.slice_cols >= 4096


@pytest.mark.parametrize(
    "shape, match",
    [
        ((1, 8, 16, MAX_N + 1, 512), "N=1025 latents is past the kernel's limit"),
        ((1, 8, 16, 64, MAX_DH + 1), "dh=4097 is past the kernel's limit"),
        ((1, 8, 16, 0, 512), "N=0 latents is past the kernel's limit"),
        ((1, 0, 16, 64, 512), "needs B, H, L >= 1"),
    ],
)
def test_plan_raises_past_the_limits(shape, match):
    with pytest.raises(ValueError, match=match):
        plan_attention(*shape, torch.float32, SMS)


@pytest.mark.parametrize("shape", [(2, 3, 5, 70, 100), (3, 2, 37, 64, 48)])
def test_wrapper_on_cpu_matches_jax(shape):
    """Ragged shapes (N past one 64-latent tile, dh not a whole stage, L not a
    whole row tile) through the wrapper on CPU tensors against the JAX
    reference, float32, within 1e-5."""
    b, h, l, n, dh = shape
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    k = rng.standard_normal((h, n, dh)).astype(np.float32)
    v = rng.standard_normal((h, n, dh)).astype(np.float32)
    got = latent_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    want = np.asarray(_reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    assert got.shape == (b, h, l, dh)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
