"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs, forward and, under autograd, backward; the tower,
the flat eval, the train steps, the trainers, serving, the end-to-end step,
the encoder and the CLIs on the card against the same on the CPU;
determinism and host syncs. Every test here skips without CUDA.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so there run
it without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import collections
import dataclasses
import gc
import json
import math
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from news_recommendation_project_v2_torch.cli.serve import build_ranker, make_server
from news_recommendation_project_v2_torch.config import (
    QUERY_INSTRUCTION,
    EncoderConfig,
    TowerConfig,
    TrainConfig,
    tower_kwargs_for_dim,
)
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors, compile_native
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower
from news_recommendation_project_v2_torch.models.convert import (
    classification_head_state_dict_from_jax,
    e2e_state_dict_from_jax,
    encoder_state_dict_from_jax,
    random_classification_head_params,
    random_encoder_params,
    latent_state_dict_from_jax,
    random_e2e_params,
    random_latent_params,
    random_reducing_params,
    random_tower_params,
    random_weighted_sum_params,
    reducing_state_dict_from_jax,
    tower_state_dict_from_jax,
    weighted_sum_state_dict_from_jax,
)
from news_recommendation_project_v2_torch.ops.geglu import _forward as geglu_forward
from news_recommendation_project_v2_torch.ops.geglu import geglu, reference_geglu
from news_recommendation_project_v2_torch.ops.latent_attention import _forward as attention_forward
from news_recommendation_project_v2_torch.ops.latent_attention import (
    MAX_N,
    ROWS,
    _launch,
    attention_smem,
    kernel_smem,
    latent_attention,
    plan_attention,
    reference_attention,
)
from news_recommendation_project_v2_torch.models.moe import MoEBlock, dispatch, held_picks
from news_recommendation_project_v2_torch.models.news_encoder import (
    HashTokenizer,
    NewsEncoder,
    encoder_config_from_hf,
    init_random_weights,
)
from news_recommendation_project_v2_torch.ops.kda import (
    kda,
    kda_gated_norm,
    kda_prep,
    recurrent_kda,
    reference_gated_norm,
    reference_kda,
    reference_kda_prep,
)
from news_recommendation_project_v2_torch.ops.moe import reference_routed_experts, routed_experts
from news_recommendation_project_v2_torch.models.towers import ClassificationHead, ReducingModel, WeightedSumModel
from news_recommendation_project_v2_torch.ops.encode import (
    TokenStore,
    build_token_store,
    encode_corpus,
    encode_corpus_bucketed,
    encode_query_and_passage,
    save_embeddings,
)
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan, score_all_impressions
from news_recommendation_project_v2_torch.ops.timing import count_syncs
from news_recommendation_project_v2_torch.utils import profiling
from news_recommendation_project_v2_torch.train.step import (
    apply_step,
    flat_infonce_loss,
    flat_infonce_step,
    flat_margin_loss,
    flat_margin_step,
    padded_infonce_loss,
    padded_margin_loss,
)
from news_recommendation_project_v2_torch.train.trainer import (
    ClassificationTrainer,
    EndToEndTrainer,
    JointTowerTrainer,
    TowerTrainer,
    make_optimizer,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attention_args(shape, dtype, device):
    b, h, l, n, dh = shape
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(
        torch.randn(*s, device=device, generator=gen).to(dtype)
        for s in ((b, h, l, dh), (h, n, dh), (h, n, dh))
    )


# One unit of the 16-bit types, relative: bfloat16 keeps 8 significant
# bits, float16 11.
UNIT = {torch.bfloat16: 2**-8, torch.float16: 2**-11}


def _attention_tol(want, dtype):
    """Both sum in float32 (the kernel's products as 3xTF32, float32-accurate);
    a bfloat16 output may round one unit apart (2^-8 of the largest), a
    float16 output one unit of the largest one's binade (2^-10 of it)."""
    top = want.float().abs().max().item()
    if dtype == torch.float16:
        return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))
    return 1e-5 if dtype == torch.float32 else 2**-8 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "shape",
    [
        (8, 8, 600, 64, 512),
        (2, 3, 5, 70, 100),
        (3, 8, 37, 64, 512),
        (8, 8, 64, 64, 512),
        (1, 8, 16, 64, 512),
        (4, 8, 300, 64, 512),
        (1, 2, 20, 1024, 1024),
    ],
    ids=["b8_l600", "unaligned", "ragged_l37", "b8_l64", "request", "medium_rows", "limits"],
)
def test_attention_kernel_matches_plain(cuda, dtype, shape):
    """Large (128-row), Medium and Small blocks as the planner picks them,
    folded rows with an L that is no multiple of a tile, N past one 64-latent
    tile, dh=100 (bfloat16 rows not 16-byte aligned: the masked loads), and
    N = dh = 1024."""
    q, k, v = _attention_args(shape, dtype, cuda)
    before = latent_attention.launches, latent_attention.shapes[shape]
    got = latent_attention(q, k, v)
    torch.cuda.synchronize()
    assert (latent_attention.launches, latent_attention.shapes[shape]) == (before[0] + 1, before[1] + 1)
    want = reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_attention_tol(want, dtype))


def _one_unit(want32: torch.Tensor, dtype) -> torch.Tensor:
    """Per element, one unit of ``dtype`` in the binade of the float32 value
    it rounds (the spacing at its size), and float32's own slack."""
    binade = torch.exp2(torch.floor(torch.log2(want32.abs().clamp_min(torch.finfo(dtype).tiny))))
    return torch.finfo(dtype).eps * binade + 1e-6 * want32.abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "shape", [(1592, 8, 32, 512, 4096), (64, 8, 64, 512, 4096), (8, 8, 32, 512, 4096), (1, 8, 50, 512, 4096)],
    ids=["encode_batch", "b64_l64", "two_slices", "one_news"],
)
def test_attention_kernel_at_the_encoder_head_in_16_bits(cuda, dtype, shape):
    """NV-Embed's head computing in the encoder's 16-bit type: 512 latents,
    8 heads of 4,096, at the encode's batch (the memory model's at width 32
    on an 80 GB card), where the rows fill the card, and where dh splits.
    The kernel sums in float32 as the plain version does and rounds once, so
    each element lies within one unit of its own size (the 16-bit spacing at
    the float32 value) of the plain version before its rounding."""
    q, k, v = _attention_args(shape, dtype, cuda)
    got = latent_attention(q, k, v)
    torch.cuda.synchronize()
    want32 = reference_attention(q.float(), k.float(), v.float())
    assert ((got.float() - want32).abs() <= _one_unit(want32, dtype)).all()


@pytest.mark.parametrize("shape, split", [((3, 8, 37, 64, 512), True), ((8, 8, 64, 64, 512), False)])
def test_attention_plan_splits_where_rows_cannot_fill(cuda, shape, split):
    """On the card's own SM count: 111 folded rows split dh into slices, 512
    do not; both agree with the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = plan_attention(*shape, torch.float32, sms)
    assert (p.slices > 1) == split
    q, k, v = _attention_args(shape, torch.float32, cuda)
    torch.testing.assert_close(latent_attention(q, k, v), reference_attention(q, k, v), rtol=0, atol=1e-5)


def _launch_attention(q, k, v, rows, slices, slice_cols):
    """The kernel under a plan of the caller's choosing, past the planner."""
    out = torch.empty_like(q)
    _launch(q, k, v, out, rows, slices, slice_cols)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_attention_planner_shared_memory_matches_the_kernel(cuda, dtype):
    """The planner's ``attention_smem`` is the CUDA source's own layout for
    every block shape and N, so the planner never picks a shape the launcher
    refuses nor passes over one that fits."""
    for rows in ROWS:
        for n in range(1, MAX_N + 1):
            assert attention_smem(rows, n, dtype) == kernel_smem(rows, n, dtype), (rows, n)
    assert kernel_smem(48, 64, dtype) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("slice_cols", [16, 48, 128])
def test_attention_kernel_every_block_shape(cuda, dtype, rows, slice_cols):
    """Every block shape and slice width on one ragged shape (M = 111
    folded rows, N = 70, dh = 100): a slice that ends inside a 64-column
    tile, and the last slice short."""
    q, k, v = _attention_args((3, 2, 37, 70, 100), dtype, cuda)
    got = _launch_attention(q, k, v, rows, -(-100 // slice_cols), slice_cols)
    torch.cuda.synchronize()
    want = reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_attention_tol(want, dtype))


def test_attention_kernel_refuses_a_bad_plan(cuda):
    q, k, v = _attention_args((1, 1, 4, 8, 32), torch.float32, cuda)
    for rows, slices, slice_cols in ((48, 1, 32), (16, 2, 32), (16, 4, 8)):
        with pytest.raises(RuntimeError, match="latent_attention kernel failed"):
            _launch_attention(q, k, v, rows, slices, slice_cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_attention_kernel_is_deterministic(cuda, dtype):
    """Slices write disjoint columns, with no atomics: the same inputs give
    the same bits on two launches, split (a single request) or not."""
    for shape in ((1, 8, 16, 64, 512), (8, 8, 600, 64, 512)):
        args = _attention_args(shape, dtype, cuda)
        first = latent_attention(*args)
        second = latent_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_attention_kernel_takes_unaligned_rows(cuda):
    """q, k and v starting 4 bytes past a 16-byte boundary: every row goes
    through the masked loads, which stage the same values as cp.async, so
    the result is the same to the bit."""
    args = _attention_args((2, 2, 40, 64, 128), torch.float32, cuda)
    shifted = [torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a) for a in args]
    assert all(t.data_ptr() % 16 == 4 for t in shifted)
    assert torch.equal(latent_attention(*shifted), latent_attention(*args))


def test_attention_wrapper_raises_past_the_limits(cuda):
    q, k, v = _attention_args((1, 1, 4, 1025, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="past the kernel's limit of 1 to 1024"):
        latent_attention(q, k, v)


GEGLU_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 2.5e-4}


def _geglu_args(shape, dtype, device):
    c, d, f = shape
    gen = torch.Generator(device=device).manual_seed(0)
    args = (
        torch.randn(c, d, device=device, generator=gen),
        torch.randn(2 * f, d, device=device, generator=gen) * d**-0.5,
        torch.randn(2 * f, device=device, generator=gen) * 0.02,
        torch.randn(d, f, device=device, generator=gen) * f**-0.5,
        torch.randn(d, device=device, generator=gen) * 0.02,
    )
    return tuple(a.to(dtype) for a in args)


GEGLU_SHAPES = {
    "request": (37, 1024, 4096), "c16": (16, 1024, 4096), "c512": (512, 1024, 4096),
    "wide_d": (37, 1536, 6144), "unaligned": (300, 96, 130),
}
# The warpgroup route's shapes, float32 only: the flat eval's row chunk, a
# ragged C past it, the NV-Embed tower's width.
GEGLU_WGMMA_SHAPES = {"flat_chunk": (4096, 1024, 4096), "c4100": (4100, 1024, 4096), "nvembed": (1024, 4096, 16384)}
GEGLU_CASES = [
    pytest.param(dtype, shape, id=f"{name}-{str(dtype)[6:]}")
    for dtype in (torch.float32, torch.bfloat16, torch.float16)
    for name, shape in GEGLU_SHAPES.items()
] + [pytest.param(torch.float32, shape, id=f"{name}-float32") for name, shape in GEGLU_WGMMA_SHAPES.items()]


@pytest.mark.parametrize("dtype, shape", GEGLU_CASES)
def test_geglu_kernel_matches_plain(cuda, dtype, shape):
    """float32 runs as 3xTF32, whose products are float32-accurate, summed in
    another order over up to 16,384 + 4,096 terms: 1e-4. In bfloat16 the
    gated product may round one bfloat16 unit apart from the plain
    version's: 1e-3; a float16 one unit of 2^-11, a quarter of that:
    2.5e-4. (300, 96, 130) has F not a multiple of 4, so W_out's
    rows are not 16-byte aligned and take the kernel's masked loads. From
    128 rows float32 takes the warpgroup route."""
    args = _geglu_args(shape, dtype, cuda)
    before = geglu.launches, geglu.shapes[shape]
    got = geglu(*args)
    torch.cuda.synchronize()
    assert (geglu.launches, geglu.shapes[shape]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=GEGLU_TOL[dtype])


def _tie_allowance(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """Per output, what the gated values near a rounding tie may move it: the
    kernel and the plain version each round u to x's type after float32 sums
    in other orders, so a u within 2^-18 of a tie may round one unit apart,
    and moves y[m, n] by that unit times |W_out[n, f]|."""
    h, g = F.linear(x.float(), w_in.float(), b_in.float()).chunk(2, dim=-1)
    u = h * F.gelu(g, approximate="tanh")
    spread = (u * (1 + 2.0**-18)).to(x.dtype).float() - (u * (1 - 2.0**-18)).to(x.dtype).float()
    return spread.abs() @ w_out.float().abs().T


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(37, 4096, 16384), (2048, 4096, 16384)], ids=["few_rows", "row_chunks"])
def test_geglu_kernel_at_the_encoder_head_in_16_bits(cuda, dtype, shape):
    """NV-Embed's head's feed-forward (D = 4,096, F = 16,384) in the
    encoder's 16-bit type; 2,048 rows of a 16,384-wide u take the planner's
    row chunks (64 MB of scratch). The narrower shapes' tolerance, plus each
    output's allowance for its gated values at a rounding tie: over 16,384
    of them a few such ties in one output pass that tolerance alone."""
    args = _geglu_args(shape, dtype, cuda)
    got = geglu(*args)
    torch.cuda.synchronize()
    gap = (got - reference_geglu(*args)).abs()
    assert (gap <= GEGLU_TOL[dtype] + _tie_allowance(*args)).all(), float(gap.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 100, 36), (130, 200, 520)])
def test_geglu_kernel_takes_ragged_edges(cuda, dtype, shape):
    """One row and one column; a D that ends inside a pipeline stage, whose
    staged rows are zero past D; C past a tile and F past a gate block. Same
    tolerances and reasons as above."""
    args = _geglu_args(shape, dtype, cuda)
    got = geglu(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=GEGLU_TOL[dtype])


@pytest.mark.parametrize(
    "dtype, shape",
    [pytest.param(dtype, (37, 1024, 4096), id=str(dtype)[6:]) for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    + [pytest.param(torch.float32, shape, id=f"{name}-float32") for name, shape in GEGLU_WGMMA_SHAPES.items()],
)
def test_geglu_kernel_is_deterministic(cuda, dtype, shape):
    """Split F sums are added in a fixed order, with no atomics: the same
    inputs give the same bits on two launches (C=37 splits pass B 8 ways;
    on the warpgroup route C=4,100 splits it 3 ways)."""
    args = _geglu_args(shape, dtype, cuda)
    first = geglu(*args)
    second = geglu(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _geglu64(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """The plain GEGLU in float64 throughout."""
    h, g = F.linear(x.double(), w_in.double(), b_in.double()).chunk(2, dim=-1)
    return F.linear(h * F.gelu(g, approximate="tanh"), w_out.double(), b_out.double())


def test_geglu_wgmma_route_is_float32_accurate(cuda):
    """At C = 4,096 the warpgroup route stays within 2e-6 of the output's
    scale (its largest magnitude) of a float64 GEGLU: the 3xTF32 split and
    the promotion of the tensor cores' short sums survive. The plain version
    with TF32 on passes that limit (H100: 5e-4 against the route's 9e-7),
    so the limit tells the two apart. geglu.routes counts the route, and
    C = 37 (one request) stays on mma.sync."""
    args = _geglu_args((4096, 1024, 4096), torch.float32, cuda)
    want = _geglu64(*args)
    limit = 2e-6 * want.abs().max().item()
    before = geglu.routes[("wgmma", torch.float32)], geglu.routes[("mma_sync", torch.float32)]
    got = geglu(*args)
    torch.cuda.synchronize()
    assert (got.double() - want).abs().max().item() <= limit
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = reference_geglu(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert (tf32.double() - want).abs().max().item() > limit
    geglu(*_geglu_args((37, 1024, 4096), torch.float32, cuda))
    after = geglu.routes[("wgmma", torch.float32)], geglu.routes[("mma_sync", torch.float32)]
    assert after == (before[0] + 1, before[1] + 1)


def test_geglu_wgmma_route_needs_aligned_operands(cuda):
    """x starting 4 bytes past a 16-byte boundary cannot feed TMA: a
    warpgroup-sized GEGLU then takes mma.sync's masked loads, with the same
    result within the float32 tolerance."""
    args = list(_geglu_args((256, 64, 48), torch.float32, cuda))
    x = torch.empty(args[0].numel() + 1, device=cuda)[1:].view_as(args[0]).copy_(args[0])
    before = geglu.routes[("mma_sync", torch.float32)]
    got = geglu(x, *args[1:])
    torch.cuda.synchronize()
    assert geglu.routes[("mma_sync", torch.float32)] == before + 1
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=GEGLU_TOL[torch.float32])


def test_geglu_kernel_takes_unaligned_rows(cuda):
    """x and W_in starting 4 bytes past a 16-byte boundary (contiguous views
    at an offset): every row goes through the masked loads, which stage the
    same values as cp.async, so the result is the same to the bit."""
    args = list(_geglu_args((33, 64, 48), torch.float32, cuda))
    shifted = [torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a) for a in args[:2]]
    assert all(t.data_ptr() % 16 == 4 for t in shifted)
    assert torch.equal(geglu(*shifted, *args[2:]), geglu(*args))


def test_kernels_refuse_autograd(cuda):
    """A kernel has no backward of its own: called directly while autograd
    records, it raises. The wrappers take it under autograd only through
    their ``autograd.Function``, whose forward runs with grad mode off, and
    launch it there."""
    q = torch.randn(1, 1, 4, 8, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 8, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention_forward(q, k, k)
    x = torch.randn(3, 8, device=cuda, requires_grad=True)
    w_in, b_in = torch.randn(32, 8, device=cuda), torch.randn(32, device=cuda)
    w_out, b_out = torch.randn(8, 16, device=cuda), torch.randn(8, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        geglu_forward(x, w_in, b_in, w_out, b_out)
    before = latent_attention.launches, geglu.launches
    assert latent_attention(q, k, k).grad_fn is not None
    assert geglu(x, w_in, b_in, w_out, b_out).grad_fn is not None
    assert (latent_attention.launches, geglu.launches) == (before[0] + 1, before[1] + 1)


def _norm_rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


@pytest.mark.parametrize("rows", [3, 1000, 65536])
def test_attention_function_gradients_match_plain_autograd(cuda, rows):
    """Full width, float32, T ragged token rows ([1, 8, T, 512] against the
    64 latents): the Function (the kernel forward, the plain backward) against
    autograd through the plain version on the card. The backward recomputes
    the probabilities from the same inputs in the same arithmetic: a
    norm-relative 1e-5."""
    q, k, v = (t.requires_grad_() for t in _attention_args((1, 8, rows, 64, 512), torch.float32, cuda))
    grad = torch.randn(q.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = latent_attention.launches
    got = torch.autograd.grad(latent_attention(q, k, v), (q, k, v), grad)
    assert latent_attention.launches == before + 1
    want = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), grad)
    for g, w in zip(got, want):
        assert _norm_rel(g, w) <= 1e-5


@pytest.mark.parametrize("rows", [3, 1000, 65536])
def test_geglu_function_gradients_match_plain_autograd(cuda, rows):
    """Full width, float32, C = T ragged rows (D=1024, F=4096): the
    Function (the kernel forward, the plain backward) against autograd
    through the plain version on the card: a norm-relative 1e-5."""
    args = tuple(t.requires_grad_() for t in _geglu_args((rows, 1024, 4096), torch.float32, cuda))
    grad = torch.randn(rows, 1024, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = geglu.launches
    got = torch.autograd.grad(geglu(*args), args, grad)
    assert geglu.launches == before + 1
    want = torch.autograd.grad(reference_geglu(*args), args, grad)
    for g, w in zip(got, want):
        assert _norm_rel(g, w) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["latent_attention", "geglu"])
def test_functions_in_16_bits_match_the_cpu(cuda, name, dtype):
    """Mixed-precision training's Functions at full width and 1,000 rows
    ([1, 8, 1000, 512] against 64 latents; C = 1,000, D = 1,024, F =
    4,096): the output and every gradient on the card (the kernel forward;
    the attention's float32 backward, the GEGLU's backward with its products
    in the 16-bit type) against the same Function on the CPU (the plain
    forward, the same backward) from the same inputs. Results that are
    rounded to the 16-bit type may round one unit apart where the two
    devices sum in other orders: a norm-relative one unit (2^-8, 2^-11)."""
    if name == "latent_attention":
        fn, args = latent_attention, _attention_args((1, 8, 1000, 64, 512), dtype, cuda)
    else:
        fn, args = geglu, _geglu_args((1000, 1024, 4096), dtype, cuda)
    results = []
    for inputs in (args, tuple(a.cpu() for a in args)):
        leaves = tuple(a.clone().requires_grad_() for a in inputs)
        before = fn.launches
        out = fn(*leaves)
        grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out.dtype)
        results.append([out.detach().cpu(), *(g.cpu() for g in torch.autograd.grad(out, leaves, grad.to(out.device)))])
        assert fn.launches == before + (inputs[0].is_cuda)
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert _norm_rel(got, want) <= UNIT[dtype]


SMALL_TOWER = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)


def _train_batch(rng, b=48, k=5, news=300, users=30, pairs=40, tokens=1024):
    """A flat batch as TowerTrainer builds one: ``users`` deduped rows'
    tokens padded to ``tokens`` (pad row b), ``pairs`` pairs padded to b,
    -1 negatives."""
    lens = rng.integers(1, 40, users)
    total = int(lens.sum())
    tok_rows = np.full(tokens, b, np.int32)
    tok_rows[:total] = np.repeat(np.arange(users), lens)
    neg = rng.integers(0, news, (b, k)).astype(np.int32)
    neg[rng.random((b, k)) < 0.2] = -1
    return (
        rng.integers(0, news, tokens).astype(np.int32), tok_rows, np.pad(lens, (0, b - users)).astype(np.float32),
        np.pad(rng.integers(0, users, pairs), (0, b - pairs)).astype(np.int32),
        np.pad(rng.integers(0, news, pairs), (0, b - pairs)).astype(np.int32), neg,
        np.pad(np.ones(pairs, np.float32), (0, b - pairs)),
    )


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_train_step_on_cuda_matches_cpu(cuda, loss):
    """The small-width flat loss and every gradient on the card (both kernels
    forward, under their Functions) against the CPU from the same weights:
    loss within 1e-5, gradients within a norm-relative 1e-4."""
    rng = np.random.default_rng(0)
    state = latent_state_dict_from_jax(random_latent_params(rng, SMALL_TOWER))
    batch = _train_batch(rng)
    if loss == "margin":
        batch = batch[:5] + (batch[5][:, 0].clip(0),) + batch[6:]
    emb = (rng.standard_normal((300, 64)) * 0.5).astype(np.float32)
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        tower = _flat_tower(SMALL_TOWER, state, dev)
        table = torch.from_numpy(emb).to(dev)
        args = (tower, table, tuple(torch.from_numpy(a).to(dev) for a in batch))
        value = flat_margin_loss(*args, margin=2.0) if loss == "margin" else flat_infonce_loss(*args)
        value.backward()
        out[key] = value.item(), {n: p.grad.cpu() for n, p in tower.named_parameters()}
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-5
    for name, g in out["cpu"][1].items():
        assert _norm_rel(out["card"][1][name], g) <= 1e-4, name


def test_train_steps_are_deterministic_on_cuda(cuda):
    """Five steps, margin and InfoNCE in turn, twice from one state: the same
    parameter bits (the pool and the pair gather's backward sum in a fixed
    order; no atomics)."""
    rng = np.random.default_rng(1)
    state = latent_state_dict_from_jax(random_latent_params(rng, SMALL_TOWER))
    nce = tuple(torch.from_numpy(a).to(cuda) for a in _train_batch(rng))
    margin = nce[:5] + (nce[5][:, 0].clamp_min(0),) + nce[6:]
    emb = torch.randn(300, 64, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    finals = []
    for _ in range(2):
        tower = _flat_tower(SMALL_TOWER, state, cuda)
        opt = make_optimizer(TrainConfig(learning_rate=1e-3), tower.parameters())
        for i in range(5):
            if i % 2:
                flat_infonce_step(tower, opt, emb, nce)
            else:
                flat_margin_step(tower, opt, emb, margin, 2.0)
        finals.append([p.detach().clone() for p in tower.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))
    assert not torch.equal(finals[0][0], state["latents"].to(cuda))


def test_train_epoch_syncs_the_host_once_a_step(cuda):
    """With loss_sync_every=1 an epoch waits for the card once a step, for
    its loss: the batches reach the card by asynchronous copies from pinned
    memory, and the clip picks its scale on the card."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=80, num_rows=120, dim=64, noise=0.05, seed=3)
    c = compile_behaviors(imps, hist).with_history_view()
    tower = build_tower(SMALL_TOWER)
    trainer = TowerTrainer(
        tower, c, align_embeddings(c.news_ids, emb), cfg=TrainConfig(batch_size=64, seed=0),
        device=cuda,
    )
    trainer.train_one_epoch()
    torch.cuda.synchronize()
    steps = len(list(trainer._epoch_batches_flat()))
    assert steps > 3
    assert count_syncs(trainer.train_one_epoch) == steps


# -- the flat step as CUDA graphs (train.graphs) ---------------------------------


def _graph_split():
    """Rows whose 64-pair batches' token streams take both buckets, T = 1,024
    and 2,048, with each bucket more than twice an epoch."""
    imps, hist, emb = synthetic_learnable_behaviors(
        num_news=200, num_rows=160, dim=64, max_history=120, noise=0.05, seed=3
    )
    c = compile_behaviors(imps, hist).with_history_view()
    return c, align_embeddings(c.news_ids, emb)


def _graph_pair(cuda, **cfg):
    """Two flat TowerTrainers on the card from one state and seed: the first
    steps through its graphs, the second, its graphs taken away, through the
    eager ``flat_margin_step`` / ``flat_infonce_step`` with the same
    (capturable) optimizer. Each keeps its steps' losses as ``_train_step``
    returned them (held, not copied) and its batches' T."""
    c, emb = _graph_split()
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(4), SMALL_TOWER))
    pair = []
    for graphed in (True, False):
        trainer = TowerTrainer(
            _flat_tower(SMALL_TOWER, state, cuda), c, emb,
            cfg=TrainConfig(**{"batch_size": 64, "seed": 0, "learning_rate": 1e-3, **cfg}), device=cuda,
        )
        assert (trainer._graphs is not None) and trainer.optimizer.param_groups[0]["capturable"]
        if not graphed:
            trainer._graphs = None
        trainer.losses, trainer.tokens = [], []

        def recorded(batch, t=trainer, step=trainer._train_step):
            t.tokens.append(batch[0].shape[0])
            t.losses.append(step(batch))
            return t.losses[-1]

        trainer._train_step = recorded
        pair.append(trainer)
    return pair


def _assert_same_bits(graphed, eager):
    """Every step's loss, the parameters and both Adam moments, to the bit."""
    assert len(graphed.losses) == len(eager.losses) > 0
    assert all(torch.equal(a, b) for a, b in zip(graphed.losses, eager.losses))
    for (name, p), q in zip(graphed.tower.named_parameters(), eager.tower.parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(graphed.optimizer.state[p][key], eager.optimizer.state[q][key]), (name, key)


def _counted(fn):
    """``fn()`` with the port's counters on; returns its result and them."""
    profiling.clear()
    with profiling.recording(True):
        out = fn()
    counters = profiling.recorded().counters
    profiling.clear()
    return out, counters


@pytest.mark.parametrize("loss, sync", [("margin", 1), ("infonce", 1), ("margin", 4)])
def test_graphed_epochs_equal_the_eager_steps(cuda, loss, sync):
    """Two epochs of the flat trainer through its graphs, over batches of both
    buckets, against the eager steps from the same state: every step's loss
    as returned (held to the end, so that a replay overwriting an earlier
    step's loss would show; with loss_sync_every=4 the trainer holds them
    too), the epoch means, the parameters and both moments, to the bit. Each
    bucket warms once and is captured once; every other step is a replay."""
    graphed, eager = _graph_pair(cuda, loss=loss, loss_sync_every=sync)
    means, counters = _counted(lambda: [graphed.train_one_epoch() for _ in range(2)])
    assert means == [eager.train_one_epoch() for _ in range(2)]
    _assert_same_bits(graphed, eager)
    assert set(graphed.tokens) == {1024, 2048}
    assert counters["train.graph_captures"] == 2
    assert counters["train.graph_replays"] == counters["train.steps"] - 2 == len(graphed.losses) - 2
    assert len({float(x) for x in graphed.losses}) == len(graphed.losses)


def test_graphs_follow_new_tables_a_restored_state_and_a_lr_cut(cuda, tmp_path):
    """``set_tables``, ``restore_training_state`` and a ``PlateauScheduler``
    cut of the learning rate, each between epochs, take effect on the next
    graphed step: the graphed trainer stays the eager one's to the bit,
    capturing its buckets again after each."""
    graphed, eager = _graph_pair(cuda, plateau_patience=1)
    other = torch.roll(graphed.news_emb_train, 1, dims=0)
    captures = []
    for t in (graphed, eager):
        t.train_one_epoch()
        t.save_training_state(tmp_path / f"state_{t is graphed}")
        events = (
            lambda: t.set_tables(other),
            lambda: t.restore_training_state(tmp_path / f"state_{t is graphed}"),
            lambda: [t.plateau.update(t.optimizer, m) for m in (1.0, 0.5, 0.5)],
        )
        for event in events:
            event()
            _, counters = _counted(t.train_one_epoch)
            captures.append(counters.get("train.graph_captures", 0))
        assert t.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    _assert_same_bits(graphed, eager)
    assert captures == [2, 2, 2, 0, 0, 0]


def test_a_signature_past_the_cap_runs_eagerly_on_cuda(cuda):
    """With room for one graph, the bucket met a second time first is graphed
    and the other runs eagerly after its warm-up, to the eager trainer's
    bits."""
    graphed, eager = _graph_pair(cuda)
    graphed._graphs.cap = 1
    _, counters = _counted(lambda: [graphed.train_one_epoch() for _ in range(2)])
    [eager.train_one_epoch() for _ in range(2)]
    _assert_same_bits(graphed, eager)
    tokens = graphed.tokens
    first = next(t for i, t in enumerate(tokens) if t in tokens[:i])
    assert [sig[0][0][0] for sig in graphed._graphs.graphs] == [first]
    assert counters["train.graph_captures"] == 1
    assert counters["train.graph_replays"] == graphed.tokens.count(first) - 1


def test_no_collection_runs_inside_a_capture(cuda):
    """Freeing a CUDA graph is not permitted while a stream captures, and a
    dropped trainer's graphs sit in reference cycles that only the collector
    frees: a collection inside one trainer's capture that freed another's
    graphs spoiled the capture. Garbage is collected before each capture, the
    collector is off during it and on again after, and the steps stay the
    eager trainer's."""
    old, _ = _graph_pair(cuda)
    old.train_one_epoch()
    gone = weakref.ref(old._graphs)
    del old, _
    graphed, eager = _graph_pair(cuda)
    seen, step = [], graphed._flat_step

    def watched(batch):
        if torch.cuda.is_current_stream_capturing():
            seen.append((gc.isenabled(), gone() is None))
        return step(batch)

    graphed._flat_step = watched
    for t in (graphed, eager):
        t.train_one_epoch()
        t.train_one_epoch()
    _assert_same_bits(graphed, eager)
    assert seen == [(False, True)] * 2
    assert gc.isenabled()


def test_replayed_steps_show_both_kernels_to_the_profiler(cuda):
    """An epoch served wholly by replays still shows both hand-written kernels
    to ``torch.profiler``'s device trace, at least once a step, so that the
    benchmark's kernel rooflines read the graphed step."""
    graphed, _ = _graph_pair(cuda)
    graphed.train_one_epoch()
    graphed.train_one_epoch()  # both buckets captured by now
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graphed.train_one_epoch()
        torch.cuda.synchronize()
    counters = profiling.recorded().counters
    profiling.clear()
    assert counters["train.graph_replays"] == counters["train.steps"] > 3
    names = [e.name() for e in prof.profiler.kineto_results.events() if "CUDA" in str(e.device_type())]
    for kernel in ("geglu_", "latent_attention_kernel"):
        assert sum(kernel in n for n in names) >= counters["train.steps"], kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_past_2_31_elements(cuda, dtype):
    """The flat eval's bfloat16 chunk gives q [1, 8, 524288, 512], 2^31
    elements: one chunk more of rows puts every offset of the last head past
    what 32 bits hold. Row pieces at both ends and across the middle match
    the plain version."""
    l = (1 << 19) + 128
    q, k, v = _attention_args((1, 8, l, 64, 512), dtype, cuda)
    assert q.numel() > 2**31
    got = latent_attention(q, k, v)
    for a in (0, (1 << 18) - 2048, l - 4096):
        want = reference_attention(q[:, :, a : a + 4096], k, v)
        torch.testing.assert_close(
            got[:, :, a : a + 4096].float(), want.float(), rtol=0, atol=_attention_tol(want, dtype)
        )


def test_geglu_at_the_flat_chunk(cuda):
    """C past the bfloat16 flat chunk of 524,288 rows (float32, so the
    comparison has no bfloat16 rounding ties): the planner's row chunks at
    the start, the middle and the end match the plain version."""
    c = (1 << 19) + 64
    x, w_in, b_in, w_out, b_out = _geglu_args((c, 1024, 4096), torch.float32, cuda)
    got = geglu(x, w_in, b_in, w_out, b_out)
    for a in (0, c // 2 - 1000, c - 2048):
        want = reference_geglu(x[a : a + 2048], w_in, b_in, w_out, b_out)
        torch.testing.assert_close(got[a : a + 2048], want, rtol=0, atol=1e-4)


def _flat_world(cfg, rows=48, news=300, seed=0):
    """A small MIND-like workload (histories straddling 256-token chunks),
    a news table and the tower's weights."""
    rng = np.random.default_rng(seed)
    hist_lens = np.minimum(rng.geometric(1 / 20, rows), 200).astype(np.int32)
    imp_lens = np.clip(rng.poisson(10, rows), 2, 40).astype(np.int32)
    labels = (rng.random(int(imp_lens.sum())) < 0.3).astype(np.float32)
    ends = np.cumsum(imp_lens)
    labels[ends - imp_lens], labels[ends - 1] = 1.0, 0.0
    return dict(
        hist=(
            rng.integers(0, news, int(hist_lens.sum())),
            hist_lens,
            rng.integers(0, news, int(imp_lens.sum())),
            np.repeat(np.arange(rows), imp_lens),
        ),
        imp_lens=imp_lens,
        labels=labels,
        emb=(rng.standard_normal((news, cfg.reduced_dim)) * 0.5).astype(np.float32),
        state=latent_state_dict_from_jax(random_latent_params(rng, cfg)),
    )


def _flat_tower(cfg, state, device):
    tower = build_tower(cfg).to(device)
    tower.load_state_dict(state)
    return tower


@pytest.mark.parametrize(
    "cfg",
    [TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16), TowerConfig()],
    ids=["small", "full_width"],
)
def test_flat_eval_on_cuda_matches_cpu(cuda, cfg):
    """FlatEvalPlan on the card (both kernels, every chunk, rows straddling
    chunks) against the same plan on the CPU (plain versions, 1e-4); its
    metrics against DeviceMetricsPlan over its own scores (1e-6); histories
    capped at 128 tokens against the padded, masked tower call of
    ``score_all_impressions`` on the card (1e-5); the tower in bfloat16, as
    bench.py casts it, within a norm-relative 3e-2 of float32."""
    w = _flat_world(cfg)
    chunks = dict(chunk_tokens=256, cand_chunk=128)
    tower = _flat_tower(cfg, w["state"], cuda)
    before = latent_attention.launches, geglu.launches
    plan = FlatEvalPlan(*w["hist"], device=cuda, **chunks)
    got = plan.score(tower, w["emb"])
    n_chunks = len(plan.history.chunks)
    assert n_chunks > 3
    assert (latent_attention.launches, geglu.launches) == (before[0] + n_chunks, before[1] + n_chunks)
    want = FlatEvalPlan(*w["hist"], device="cpu", **chunks).score(_flat_tower(cfg, w["state"], "cpu"), w["emb"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mplan = DeviceMetricsPlan(w["imp_lens"], w["labels"], hist_slots=np.arange(len(got)), device=cuda)
    m = plan.metrics(tower, w["emb"], mplan)
    direct = mplan.compute(got)
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert abs(m[key] - direct[key]) <= 1e-6, key
    capped = FlatEvalPlan(*w["hist"], max_len=128, device=cuda, **chunks).score(tower, w["emb"])
    padded = score_all_impressions(tower, w["emb"], *w["hist"], batch_size=16, buckets=(16, 64, 128), device=cuda)
    np.testing.assert_allclose(padded, capped, rtol=0, atol=1e-5)
    bf16 = _flat_tower(dataclasses.replace(cfg, compute_dtype="bfloat16"), w["state"], cuda).to(torch.bfloat16)
    query = torch.from_numpy(w["emb"]).to(cuda, torch.bfloat16)
    got16 = plan.score(bf16, w["emb"], query_news_emb=query)
    assert np.linalg.norm(got16 - got) <= 3e-2 * np.linalg.norm(got)


def test_flat_segment_add_is_deterministic(cuda):
    """The pool's segment-add sums each row's run in order and adds each row
    once a chunk (no atomics race on a row): two runs give the same bits,
    with rows straddling 64-token chunks."""
    cfg = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)
    w = _flat_world(cfg, rows=200, seed=1)
    tower = _flat_tower(cfg, w["state"], cuda)
    plan = FlatEvalPlan(*w["hist"], chunk_tokens=64, cand_chunk=512, device=cuda)
    first, second = plan.score(tower, w["emb"]), plan.score(tower, w["emb"])
    assert first.tobytes() == second.tobytes()


def test_flat_metrics_sync_the_host_once(cuda):
    """FlatEvalPlan.metrics waits for the card once, for its five sums."""
    cfg = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)
    w = _flat_world(cfg)
    tower = _flat_tower(cfg, w["state"], cuda)
    emb = torch.from_numpy(w["emb"]).to(cuda)
    plan = FlatEvalPlan(*w["hist"], chunk_tokens=256, device=cuda)
    mplan = DeviceMetricsPlan(w["imp_lens"], w["labels"], hist_slots=np.arange(len(w["labels"])), device=cuda)
    plan.metrics(tower, emb, mplan)
    torch.cuda.synchronize()
    assert count_syncs(lambda: plan.metrics(tower, emb, mplan, alpha=0.5)) == 1


@pytest.mark.parametrize(
    "cfg",
    [TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16), TowerConfig()],
    ids=["small", "full_width"],
)
def test_tower_on_cuda_matches_cpu(cuda, cfg):
    """The tower through both kernels on the card against the same weights
    through the plain versions on the CPU, pooled and per token (float32)."""
    rng = np.random.default_rng(0)
    sd = latent_state_dict_from_jax(random_latent_params(rng, cfg))
    emb = rng.standard_normal((3, 37, cfg.reduced_dim)).astype(np.float32)
    mask = np.ones((3, 37), np.float32)
    mask[1, 20:] = 0.0
    emb *= mask[..., None]
    towers = {}
    for dev in ("cpu", cuda):
        towers[dev] = build_tower(cfg).to(dev)
        towers[dev].load_state_dict(sd)
    before = latent_attention.launches, geglu.launches
    with torch.no_grad():
        for m in (mask, None):
            outs = [
                towers[dev](torch.from_numpy(emb).to(dev), None if m is None else torch.from_numpy(m).to(dev))
                for dev in ("cpu", cuda)
            ]
            torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=0, atol=1e-4)
    assert (latent_attention.launches, geglu.launches) == (before[0] + 2, before[1] + 2)


# -- the padded path -------------------------------------------------------------

PADDED = {
    "latent": SMALL_TOWER,
    "final_attention": TowerConfig(kind="final_attention", reduced_dim=64, hidden_dim=128),
    "transformer": TowerConfig(kind="transformer", reduced_dim=64, num_layers=2),
}


def _padded_tower(kind, device, cfg=None):
    cfg = cfg or PADDED[kind]
    tower = build_tower(cfg)
    tower.load_state_dict(tower_state_dict_from_jax(cfg.kind, random_tower_params(np.random.default_rng(3), cfg)))
    return tower.to(device)


def _padded_batch(rng, b=48, u=30, l=64, k=5, news=300, pairs=None):
    """A padded batch as TowerTrainer._epoch_batches builds one: u deduped
    histories end-aligned into [b, l] (rows past u all pad), ``pairs`` real
    pairs (b - 8 by default) and pad pairs, -1 negatives."""
    lens = rng.integers(1, l + 1, u)
    mask = np.zeros((b, l), np.float32)
    mask[:u] = np.arange(l)[None] < lens[:, None]
    idx = (rng.integers(0, news, (b, l)) * mask).astype(np.int32)
    neg = rng.integers(0, news, (b, k)).astype(np.int32)
    neg[rng.random((b, k)) < 0.2] = -1
    real = b - 8 if pairs is None else pairs
    return (
        idx, mask, np.pad(rng.integers(0, u, real), (0, b - real)).astype(np.int32),
        np.pad(rng.integers(0, news, real), (0, b - real)).astype(np.int32), neg,
        np.pad(np.ones(real, np.float32), (0, b - real)),
    )


@pytest.mark.parametrize("cfg", [SMALL_TOWER, TowerConfig()], ids=["small", "full_width"])
def test_latent_padded_forward_and_step_match_cpu(cuda, cfg):
    """The latent tower at a padded, folded [B, 8, L, dh] shape (all-pad
    rows included) through both kernels, against the plain versions on the
    CPU: the pooled output within 1e-4 and, under autograd, the padded
    margin loss within 1e-5 and every gradient within a norm-relative 1e-4.
    Each kernel launches once per forward."""
    rng = np.random.default_rng(4)
    sd = latent_state_dict_from_jax(random_latent_params(rng, cfg))
    batch = _padded_batch(rng, b=24, u=16, l=64, news=300)
    batch = batch[:4] + (batch[4][:, 0].clip(0),) + batch[5:]
    emb = (rng.standard_normal((300, cfg.reduced_dim)) * 0.5).astype(np.float32)
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        tower = _flat_tower(cfg, sd, dev)
        table = torch.from_numpy(emb).to(dev)
        tb = tuple(torch.from_numpy(a).to(dev) for a in batch)
        before = latent_attention.launches, geglu.launches
        with torch.no_grad():
            pooled = tower(table[tb[0].long()] * tb[1][..., None], tb[1])
        loss = padded_margin_loss(tower, table, tb, 2.0)
        loss.backward()
        if key == "card":
            assert (latent_attention.launches, geglu.launches) == (before[0] + 2, before[1] + 2)
        out[key] = pooled.cpu(), loss.item(), {n: p.grad.cpu() for n, p in tower.named_parameters()}
    assert torch.isfinite(out["card"][0]).all()
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=0, atol=1e-4)
    assert abs(out["card"][1] - out["cpu"][1]) <= 1e-5
    for name, g in out["cpu"][2].items():
        assert _norm_rel(out["card"][2][name], g) <= 1e-4, name


@pytest.mark.parametrize("step, compute", [("flat", "float16"), ("flat", "bfloat16"), ("padded", "bfloat16")])
def test_16_bit_steps_match_the_cpu(cuda, step, compute):
    """A full-width latent tower's margin step in a 16-bit type at B = 8
    (the flat step over its tokens, the padded one over [8, 32] histories):
    the card's loss within 1e-3 of the CPU's in the same type, and every
    leaf's gradient g, with the CPU's float32 (g32) and 16-bit (gc) ones,
    |g - g32| <= 1.5 |gc - g32| + 5e-3 |g32| and |g - gc| <= 0.15 |gc|
    (norms): tests/test_torch_mixed_precision.py's criteria, with the CPU's
    gradients in place of the JAX package's."""
    rng = np.random.default_rng(14)
    cfg = TowerConfig()
    state = latent_state_dict_from_jax(random_latent_params(rng, cfg))
    emb = (rng.standard_normal((300, cfg.reduced_dim)) * 0.5).astype(np.float32)
    if step == "flat":
        batch = _train_batch(rng, b=8, users=8, pairs=8, tokens=512)
        batch = batch[:5] + (batch[5][:, 0].clip(0),) + batch[6:]
        loss_fn = flat_margin_loss
    else:
        batch = _padded_batch(rng, b=8, u=8, l=32, pairs=8)
        batch = batch[:4] + (batch[4][:, 0].clip(0),) + batch[5:]
        loss_fn = padded_margin_loss
    runs = {}
    for key, dev, dtype in (("card", cuda, compute), ("cpu", "cpu", compute), ("cpu32", "cpu", "float32")):
        tower = _flat_tower(dataclasses.replace(cfg, compute_dtype=dtype), state, dev)
        table = torch.from_numpy(emb).to(dev)
        loss = loss_fn(tower, table, tuple(torch.from_numpy(a).to(dev) for a in batch), 2.0)
        loss.backward()
        runs[key] = loss.item(), {n: p.grad.double().cpu() for n, p in tower.named_parameters()}
    (loss_card, g), (loss_cpu, gc), (_, g32) = runs["card"], runs["cpu"], runs["cpu32"]
    assert abs(loss_card - loss_cpu) <= 1e-3
    assert set(g) == set(gc) == set(g32)
    for n in g32:
        assert (g[n] - g32[n]).norm() <= 1.5 * (gc[n] - g32[n]).norm() + 5e-3 * g32[n].norm(), n
        assert (g[n] - gc[n]).norm() <= 0.15 * gc[n].norm(), n


@pytest.mark.parametrize(
    "kind, extra",
    [pytest.param("final_attention", {}, id="final_attention"), pytest.param("transformer", {}, id="transformer"),
     pytest.param("transformer", {"as_built": True}, id="transformer_as_built")],
)
def test_padded_towers_keep_all_pad_rows_finite_on_cuda(cuda, kind, extra):
    """A fully padded row stays finite on the card (the transformer's
    additive float32 mask gives a uniform softmax), and the towers match the
    CPU within 1e-4 at full width; the card's tower computing in bfloat16
    stays finite and within a norm-relative 3e-2 of its float32 output."""
    cfg = TowerConfig(kind=kind, **extra)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((4, 37, 1024)).astype(np.float32)
    mask = np.ones((4, 37), np.float32)
    mask[1, 10:] = 0.0
    mask[2] = 0.0
    emb *= mask[..., None]
    outs = []
    for dev, c in (("cpu", cfg), (cuda, cfg), (cuda, dataclasses.replace(cfg, compute_dtype="bfloat16"))):
        with torch.no_grad():
            outs.append(_padded_tower(kind, dev, c)(torch.from_numpy(emb).to(dev), torch.from_numpy(mask).to(dev)).float().cpu())
    assert torch.isfinite(outs[1]).all() and torch.isfinite(outs[2]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    assert _norm_rel(outs[2], outs[1]) <= 3e-2


@pytest.mark.parametrize("kind", list(PADDED))
def test_padded_eval_on_cuda_matches_cpu(cuda, kind):
    """``score_all_impressions(flat_tokens=False)`` on the card against the
    CPU, small buckets so that every bucket and the cap are met."""
    w = _flat_world(SMALL_TOWER)
    scores = [
        score_all_impressions(_padded_tower(kind, dev), w["emb"], *w["hist"], batch_size=16, buckets=(16, 64, 128), device=dev)
        for dev in ("cpu", cuda)
    ]
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["latent", "transformer"])
def test_padded_train_steps_are_deterministic_on_cuda(cuda, kind):
    """Five padded steps, margin and InfoNCE in turn, dropout on (rate 0.1,
    masks from one seeded CUDA generator), twice from one state: the same
    parameter bits. A margin step with its loss fetched waits for the card
    once."""
    rng = np.random.default_rng(6)
    nce = tuple(torch.from_numpy(a).to(cuda) for a in _padded_batch(rng))
    margin = nce[:4] + (nce[4][:, 0].clamp_min(0),) + nce[5:]
    emb = torch.randn(300, 64, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    finals = []
    for _ in range(2):
        tower = _padded_tower(kind, cuda)
        gen = torch.Generator(device=cuda).manual_seed(7)
        opt = make_optimizer(TrainConfig(learning_rate=1e-3), tower.parameters())
        for i in range(5):
            loss = padded_infonce_loss(tower, emb, nce, gen) if i % 2 else padded_margin_loss(tower, emb, margin, 2.0, gen)
            apply_step(opt, loss)
        finals.append([p.detach().clone() for p in tower.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))
    torch.cuda.synchronize()
    assert count_syncs(lambda: float(apply_step(opt, padded_margin_loss(tower, emb, margin, 2.0, gen)))) == 1


# -- the trainers, epoch by epoch ------------------------------------------------

METRIC_KEYS = ("auc", "mrr", "ndcg5", "ndcg10")
# The padded towers and the heads at bench.py's trained-metrics fixture's
# width, 2 epochs of it.
SMALL_PADDED = dict(reduced_dim=64, embedding_dim=64, hidden_dim=128, num_layers=1, dropout_rate=0.0)
FIXTURE_TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=128, seed=0)


def _learnable_split(num_rows=800, n_train=600, dim=64, seed=7):
    """bench.py's trained-metrics fixture: the learnable behaviors split into
    train and val rows, each with its aligned table."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=200, num_rows=num_rows, dim=dim, noise=0.05, seed=seed)
    ct = compile_behaviors(imps[:n_train], hist[:n_train]).with_history_view()
    cv = compile_behaviors(imps[n_train:], hist[n_train:]).with_history_view()
    return ct, cv, align_embeddings(ct.news_ids, emb), align_embeddings(cv.news_ids, emb)


def _heads(dim=64):
    """The classification head, the blend and the reducer from one numpy seed."""
    rng = np.random.default_rng(85)
    head = ClassificationHead(dim, dim)
    head.load_state_dict(classification_head_state_dict_from_jax(random_classification_head_params(rng, dim, dim)))
    blend, reduce = WeightedSumModel(), ReducingModel(dim, dim)
    blend.load_state_dict(weighted_sum_state_dict_from_jax(random_weighted_sum_params(rng)))
    reduce.load_state_dict(reducing_state_dict_from_jax(random_reducing_params(rng, dim, dim)))
    return head, blend, reduce


def _trainer_run(name, dev, split, baseline=None):
    """One trainer of ``name`` on ``dev`` over ``split``: its history, and
    for the classification trainer its baseline scores of both tables."""
    ct, cv, emb_t, emb_v = split
    val = dict(compiled_val=cv, news_emb_val=emb_v)
    if name == "latent":
        cfg = TowerConfig(kind="latent", reduced_dim=64, num_latents=8, latent_dim_head=16)
        tower = _flat_tower(cfg, latent_state_dict_from_jax(random_latent_params(np.random.default_rng(0), cfg)), dev)
        trainer = TowerTrainer(tower, ct, emb_t, **val, device_metrics=True, device=dev,
                               cfg=TrainConfig(learning_rate=3e-4, num_epochs=3, batch_size=128, seed=0))
        return trainer.train(), None
    head, blend, reduce = _heads()
    if name == "classification":
        trainer = ClassificationTrainer(head, ct, emb_t, **val, cfg=TrainConfig(**FIXTURE_TRAIN), device=dev)
        return trainer.train(), (trainer.baseline_scores(emb_t), trainer.baseline_scores(emb_v))
    kind = "final_attention" if name == "joint" else name
    cfg = TowerConfig(kind=kind, **SMALL_PADDED)
    tower = build_tower(cfg)
    tower.load_state_dict(tower_state_dict_from_jax(kind, random_tower_params(np.random.default_rng(0), cfg)))
    tower.to(dev)
    if name == "joint":  # the blend and the reducer drawn with the head, as the classification run's
        trainer = JointTowerTrainer(tower, ct, emb_t, blend=blend, reduce=reduce, baseline_train=baseline[0],
                                    baseline_val=baseline[1], **val, cfg=TrainConfig(**FIXTURE_TRAIN), flat_eval=False,
                                    device=dev)
    else:
        trainer = TowerTrainer(tower, ct, emb_t, **val, cfg=TrainConfig(**FIXTURE_TRAIN), flat_train=False,
                               flat_eval=False, device=dev)
    return trainer.train(), None


@pytest.mark.parametrize("name", ["latent", "final_attention", "transformer", "classification", "joint"])
def test_trainer_on_cuda_matches_cpu_epoch_by_epoch(cuda, name):
    """A trainer on bench.py's trained-metrics fixture (d = 64, 600 / 200
    rows) on the card against the same trainer on the CPU, epoch by epoch:
    the loss within 1e-5 relative, the val metrics within 2e-3 (the CPU
    tests' tolerances). ``latent``: TowerTrainer on the flat step and eval
    with the metrics on the card, 3 epochs, both kernels launched, its best
    val AUC past bench.py's gate of 0.58; ``final_attention`` and
    ``transformer``: TowerTrainer's padded step and bucketed eval, 2 epochs;
    ``classification``: ClassificationTrainer; ``joint``: JointTowerTrainer
    blending a final_attention tower with the card's classification
    baseline and reducing both tables."""
    split = _learnable_split()
    baseline = _trainer_run("classification", cuda, split)[1] if name == "joint" else None
    before = latent_attention.launches, geglu.launches
    card, _ = _trainer_run(name, cuda, split, baseline)
    if name == "latent":
        assert latent_attention.launches > before[0] and geglu.launches > before[1]
        assert max(h["val"]["auc"] for h in card) > 0.58
    cpu, _ = _trainer_run(name, "cpu", split, baseline)
    assert len(card) == len(cpu) > 1
    for got, want in zip(card, cpu):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got, want)
        for k in METRIC_KEYS:
            assert abs(got["val"][k] - want["val"][k]) <= 2e-3, (k, got, want)


# -- serving ---------------------------------------------------------------------

# Scores on the card against the CPU's ranker: the latent tower's float32
# ones within 1e-4, the other towers' within 1e-5 and in the CPU's order;
# float16 within a norm-relative 3e-2 of the CPU's float16 ranker.
SERVE_TOL = {"latent": 1e-4, "final_attention": 1e-5, "transformer": 1e-5}


def _requests(rng, ids, n):
    """MIND-like requests: geometric histories (mean 29, capped at 600),
    10-90 candidates."""
    out = []
    for _ in range(n):
        h, c = int(np.clip(rng.geometric(1 / 29.0), 1, 600)), int(rng.integers(10, 90))
        out.append(([ids[j] for j in rng.integers(0, len(ids), h)], [ids[j] for j in rng.integers(0, len(ids), c)]))
    return out


def _order_agrees(got, want, slack):
    """``got`` holds ``want``'s candidates in ``want``'s order but where two
    of ``want``'s scores lie within ``slack`` of each other."""
    score = dict(want)
    ids = [c for c, _ in got]
    return sorted(ids) == sorted(c for c, _ in want) and all(
        score[b] <= score[a] + slack for i, a in enumerate(ids) for b in ids[i + 1:]
    )


def _check_ranked(ranked, candidates):
    scores = np.array([s for _, s in ranked])
    assert sorted(c for c, _ in ranked) == sorted(candidates)
    assert np.isfinite(scores).all() and (np.diff(scores) <= 0).all()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{path}", data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize(
    "kind, compute",
    [("latent", "float32"), ("final_attention", "float32"), ("transformer", "float32"), ("latent", "float16")],
)
def test_served_ranker_on_cuda_matches_cpu(cuda, tmp_path, kind, compute):
    """``cli.serve.build_ranker`` (as ``nrtorch-serve --tower KIND --dim 64``
    builds it) over an id-keyed dump of 500 news and a saved tower, on the
    card against the same ranker on the CPU: a ``rank_batch`` of 32
    MIND-like requests, one request's ``rank`` and one HTTP ``POST /rank``
    (``make_server``), each ranking the request's candidates, its scores
    finite and descending and within ``SERVE_TOL`` of the CPU's (float16: a
    norm-relative 3e-2 a request), the ids in the CPU's order (the latent
    tower's up to near-ties: where two CPU scores lie within twice the
    largest score difference); ``retrieve(k=10)``. The latent tower in
    float32 takes the GEGLU's warpgroup route over the batch's grids and
    mma.sync for the short request."""
    rng = np.random.default_rng(0)
    cfg = TowerConfig(kind=kind, compute_dtype=compute, **tower_kwargs_for_dim(64))
    ckpt = tmp_path / "tower.pt"
    torch.save(tower_state_dict_from_jax(kind, random_tower_params(rng, cfg)), ckpt)
    ids = [f"N{i}" for i in range(500)]
    save_embeddings(tmp_path / "emb", "MINDsmall_dev", rng.standard_normal((500, 64), dtype=np.float32) * 0.05,
                    news_ids=np.array(ids))
    requests = _requests(rng, ids, 32)
    short = (ids[:5], ids[5:25])
    ranker = build_ranker(tmp_path / "emb", "MINDsmall_dev", ckpt, cfg, device=cuda)
    routes = collections.Counter(geglu.routes)
    launches = latent_attention.launches, geglu.launches
    got = ranker.rank_batch(requests) + [ranker.rank(*short)]
    server = make_server(ranker, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        posted = _post(server.server_address[1], "rank", {"history": requests[1][0], "candidates": requests[1][1]})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    got.append([tuple(r) for r in posted["ranked"]])
    top = ranker.retrieve(requests[0][0], k=10)
    assert len(top) == 10 and (np.diff([s for _, s in top]) <= 0).all()
    if kind == "latent":
        assert latent_attention.launches > launches[0] and geglu.launches > launches[1]
    if (kind, compute) == ("latent", "float32"):
        assert geglu.routes[("wgmma", torch.float32)] > routes[("wgmma", torch.float32)]
        assert geglu.routes[("mma_sync", torch.float32)] > routes[("mma_sync", torch.float32)]
    cpu = build_ranker(tmp_path / "emb", "MINDsmall_dev", ckpt, cfg, device="cpu")
    want = cpu.rank_batch(requests) + [cpu.rank(*short), cpu.rank(*requests[1])]
    for (_, cands), g, w in zip(requests + [short, requests[1]], got, want, strict=True):
        _check_ranked(g, cands)
        a, b = dict(g), dict(w)
        diff = np.array([a[c] - b[c] for c in cands])
        if compute == "float16":
            assert np.linalg.norm(diff) <= 3e-2 * np.linalg.norm([b[c] for c in cands])
        else:
            assert np.abs(diff).max() <= SERVE_TOL[kind]
        if kind == "latent":
            assert _order_agrees(g, w, 2 * float(np.abs(diff).max()))
        else:
            assert [c for c, _ in g] == [c for c, _ in w]


# -- the end-to-end path (config[2]) ------------------------------------------

E2E_SHAPE = (64, 8, 64, 16, 256)  # run_config2's tower at full width: 16 latents, 8 heads x 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_the_e2e_width(cuda, dtype):
    """N=16 latents, dh=256, the shape the end-to-end tower launches: the
    planner's shared memory for it equals the CUDA source's layout; the
    kernel against its plain version forward, and under the Function's
    backward against autograd through the plain version (float32)."""
    b, h, l, n, dh = E2E_SHAPE
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = plan_attention(b, h, l, n, dh, dtype, sms)
    assert p.smem_bytes == attention_smem(p.rows, n, dtype) == kernel_smem(p.rows, n, dtype)
    q, k, v = _attention_args(E2E_SHAPE, dtype, cuda)
    want = reference_attention(q, k, v)
    torch.testing.assert_close(latent_attention(q, k, v).float(), want.float(), rtol=0, atol=_attention_tol(want, dtype))
    if dtype == torch.float32:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        grad = torch.randn(q.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
        got = torch.autograd.grad(latent_attention(q, k, v), (q, k, v), grad)
        plain = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), grad)
        for g, w in zip(got, plain):
            assert _norm_rel(g, w) <= 1e-5


E2E_TOWER = TowerConfig(reduced_dim=64, num_latents=16, num_heads=8, latent_dim_head=16)


def _e2e_model(device, seed=0, dropout=True):
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(64, 1), "tower": build_tower(E2E_TOWER)})
    model.load_state_dict(e2e_state_dict_from_jax(random_e2e_params(np.random.default_rng(seed), 64, 1, E2E_TOWER)))
    if not dropout:
        for layer in model["token_encoder"].encoder.layer:
            layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return model.to(device)


def _e2e_fixture(num_rows=120):
    imps, hist, emb = synthetic_learnable_behaviors(num_news=80, num_rows=num_rows, dim=64, noise=0.05, seed=3)
    c = compile_behaviors(imps, hist).with_history_view()
    rng = np.random.default_rng(4)
    emb = align_embeddings(c.news_ids, emb)
    arrays = [emb[i][None] + rng.standard_normal((int(rng.integers(2, 12)), 64)).astype(np.float32) * 0.05 for i in range(len(emb))]
    return c, TokenStore.from_ragged(arrays)


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_e2e_step_on_cuda_matches_cpu(cuda, loss):
    """One end-to-end batch (the trainer's first, from the resident store)
    on the card against the CPU from the same weights, dropout off: the
    loss within 1e-5, every gradient of both modules within a norm-relative
    1e-4; both kernels launched."""
    c, store = _e2e_fixture()
    cfg = TrainConfig(batch_size=32, loss=loss, num_neg_per_pos=3, seed=0)
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        model = _e2e_model(dev, dropout=False)
        trainer = EndToEndTrainer(model["token_encoder"], model["tower"], c, store, cfg=cfg, max_token_len=16, device=dev)
        batch = tuple(torch.from_numpy(a).to(dev) for a in next(trainer._epoch_batches()))
        before = latent_attention.launches, geglu.launches
        value = trainer._loss(batch)
        value.backward()
        if key == "card":
            assert latent_attention.launches > before[0] and geglu.launches > before[1]
        out[key] = value.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-5
    for name, g in out["cpu"][1].items():
        assert _norm_rel(out["card"][1][name], g) <= 1e-4, name


def test_e2e_device_store_and_streamed_are_identical_on_cuda(cuda):
    """One epoch with dropout on: the resident store and the streamed one
    give the same losses and parameter bits on the card, and a second run
    of the resident route repeats them; the news vectors materialized from
    the resident states and from the streamed store agree within 1e-6."""
    c, store = _e2e_fixture()
    cfg = TrainConfig(batch_size=32, learning_rate=1e-3, seed=0)
    runs = []
    for device_store in (False, True, True):
        model = _e2e_model(cuda)
        trainer = EndToEndTrainer(
            model["token_encoder"], model["tower"], c, store, cfg=cfg, max_token_len=16, device_store=device_store, device=cuda
        )
        loss = trainer.train_one_epoch()
        runs.append((loss, [p.detach().clone() for p in model.parameters()], trainer.materialize_news_embeddings()))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], other[1]))
    assert np.isfinite(runs[1][2]).all()
    np.testing.assert_allclose(runs[1][2], runs[0][2], rtol=0, atol=1e-6)


# -- the news encoder: NV-Embed's pooling head --------------------------------

HEAD_SHAPES = [(3, 8, 37, 512, 1040), (2, 8, 32, 512, 2048), (1, 8, 16, 512, 4096), (8, 8, 32, 512, 4096),
               (64, 8, 32, 512, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=["dh1040_ragged", "dh2048", "dh4096_one_news", "dh4096_b8", "dh4096_b64"])
def test_attention_at_the_encoder_head(cuda, dtype, shape):
    """N = 512 latents and dh up to 4,096 (NV-Embed's head: 8 heads x 4,096),
    ragged (folded rows past a tile, dh = 1,040 not a whole stage) and
    whole, through the Small, Pair and Medium blocks the planner picks: the
    planner's shared memory equals the CUDA source's layout, and the kernel
    agrees with its plain version."""
    b, h, l, n, dh = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = plan_attention(b, h, l, n, dh, dtype, sms)
    assert p.smem_bytes == attention_smem(p.rows, n, dtype) == kernel_smem(p.rows, n, dtype)
    q, k, v = _attention_args(shape, dtype, cuda)
    before = latent_attention.shapes[shape]
    got = latent_attention(q, k, v)
    torch.cuda.synchronize()
    assert latent_attention.shapes[shape] == before + 1
    want = reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_one_unit(want, dtype))


def _one_unit(want, dtype):
    """float32: 1e-5. bfloat16: one unit in the last place at the output's
    largest magnitude, the most that two float32-accurate results rounded to
    bfloat16 apart can differ (2^-8 of the largest value is less than that
    unit when it lies low in its binade)."""
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


@pytest.mark.parametrize("c", [256, 1500])
def test_geglu_at_the_encoder_head(cuda, c):
    """The head's GEGLU, float32 as the head computes: D = 4,096, F =
    16,384, so u is 64 KB a row and the 64 MB scratch takes 1,024 rows a
    chunk (C = 1,500 runs two)."""
    args = _geglu_args((c, 4096, 16384), torch.float32, cuda)
    got = geglu(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=1e-4)


SMALL_ENCODERS = {
    "bert": dict(),
    "qwen2": dict(arch="qwen2", num_kv_heads=2, pooling="last"),
    "nv_embed": dict(arch="qwen2", num_kv_heads=2, qkv_bias=False, bidirectional=True, latent_pool=True,
                     latent_pool_num_latents=6, latent_pool_heads=2, latent_pool_dim_head=8),
}


def _small_encoder(layout, device):
    cfg = EncoderConfig(vocab_size=97, hidden_dim=32, num_layers=2, num_heads=4, intermediate_dim=64,
                        max_position=40, compute_dtype="float32", **SMALL_ENCODERS[layout])
    enc = NewsEncoder(cfg)
    enc.load_state_dict(encoder_state_dict_from_jax(random_encoder_params(cfg, 0), cfg))
    return enc.to(device).eval()


@pytest.mark.parametrize("layout", list(SMALL_ENCODERS))
def test_small_encoder_on_cuda_matches_cpu(cuda, layout):
    """A small encoder of each layout, float32: hidden states and pooled
    vectors on the card within 1e-5 of the CPU, an all-pad row included;
    NV-Embed's head launches both kernels."""
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 97, (4, 11)).astype(np.int32)
    mask = np.zeros((4, 11), np.int32)
    for i, n in enumerate((11, 7, 1, 0)):
        mask[i, :n] = 1
    out = {}
    launches = latent_attention.launches, geglu.launches
    for dev in ("cpu", cuda):
        enc = _small_encoder(layout, dev)
        args = (torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        with torch.no_grad():
            out[str(dev)] = enc.hidden_states(*args).cpu(), enc(*args).cpu()
    if layout == "nv_embed":
        assert latent_attention.launches > launches[0] and geglu.launches > launches[1]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_corpus_encode_and_token_store_on_cuda_match_cpu(cuda):
    """encode_query_and_passage (bucketed) and build_token_store on the card
    against the CPU: vectors and states within 1e-5, offsets equal."""
    rng = np.random.default_rng(2)
    texts = [" ".join(f"w{rng.integers(50)}" for _ in range(int(n))) for n in rng.integers(1, 30, size=29)]
    tok = HashTokenizer(vocab_size=97, max_length=40)
    ids, mask = tok(texts)
    res = {}
    for dev in ("cpu", cuda):
        enc = _small_encoder("nv_embed", dev)
        tables = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 8, buckets=(8, 16, 32), device=dev)
        res[str(dev)] = [t.cpu() for t in tables], build_token_store(enc, ids, mask, batch_size=8, device=dev)
    for got, want in zip(res["cuda"][0], res["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(res["cuda"][1].offsets, res["cpu"][1].offsets)
    np.testing.assert_allclose(res["cuda"][1].states, res["cpu"][1].states, rtol=0, atol=1e-5)


def test_bucketed_encode_splits_evenly_on_cuda(cuda):
    """A bucketed encode on the card under a cap of 16 rows: the 17 rows of
    width 8 split into two batches of 16 on the current stream, the 3 rows
    of width 32 run as one batch of 8 on the side stream
    (``SIDE_STREAM_TOKENS``); the vectors equal the fixed-width encode's
    within 1e-5."""
    rng = np.random.default_rng(3)
    lens = np.concatenate([rng.integers(1, 9, 17), rng.integers(20, 33, 3)])
    ids = rng.integers(3, 97, (20, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < lens[:, None]).astype(np.int32)
    enc = _small_encoder("nv_embed", cuda)
    main = torch.cuda.current_stream(cuda)
    seen = []
    hook = enc.register_forward_pre_hook(
        lambda _, args: seen.append((tuple(args[0].shape), torch.cuda.current_stream(cuda) == main))
    )
    try:
        got = encode_corpus_bucketed(enc, ids, mask, buckets=(8,), batch_size=16, device=cuda)
    finally:
        hook.remove()
    assert seen == [((16, 8), True), ((16, 8), True), ((8, 32), False)]
    want = encode_corpus(enc, ids, mask, batch_size=8, device=cuda)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_device_counter_sums_counts_from_two_streams(cuda):
    """``profiling.count_device`` called in turns on a side stream and the
    current one, each count written behind a long GEMM on its stream:
    ``recorded()`` reads the sum of every count (a running sum kept on
    whichever stream was current read the other stream's count before it
    was written)."""
    streams = [torch.cuda.Stream(cuda), torch.cuda.current_stream(cuda)]
    work = [torch.randn(4096, 4096, device=cuda) for _ in streams]
    torch.cuda.synchronize()
    profiling.clear()
    try:
        with profiling.recording(True):
            for i in range(20):
                with torch.cuda.stream(streams[i % 2]):
                    w = work[i % 2]
                    for _ in range(3):
                        w = torch.tanh(w @ w)
                    n = torch.full((), i + 1, dtype=torch.int32, device=cuda) + (w[0, 0] * 0).to(torch.int32)
                    profiling.count_device("test.counts", n)
            got = profiling.recorded().counters["test.counts"]
    finally:
        profiling.clear()
    assert got == sum(range(1, 21))


def test_bucketed_encode_queues_the_side_stream_bucket_last_on_cuda(cuda):
    """The narrow bucket is the small one (3 rows of width 8, the side
    stream) and the wide bucket the large one (17 rows of width 32, two
    batches of 16): the wide bucket's batches are queued first on the current
    stream, so the card has work while the host launches the side stream's
    batch; the vectors equal the fixed-width encode's within 1e-5."""
    rng = np.random.default_rng(4)
    lens = np.concatenate([rng.integers(1, 9, 3), rng.integers(20, 33, 17)])
    ids = rng.integers(3, 97, (20, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < lens[:, None]).astype(np.int32)
    enc = _small_encoder("nv_embed", cuda)
    main = torch.cuda.current_stream(cuda)
    seen = []
    hook = enc.register_forward_pre_hook(
        lambda _, args: seen.append((tuple(args[0].shape), torch.cuda.current_stream(cuda) == main))
    )
    try:
        got = encode_corpus_bucketed(enc, ids, mask, buckets=(8,), batch_size=16, device=cuda)
    finally:
        hook.remove()
    assert seen == [((16, 32), True), ((16, 32), True), ((8, 8), False)]
    want = encode_corpus(enc, ids, mask, batch_size=8, device=cuda)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# -- the news encoder: Moonlight's routed experts ---------------------------------

MOONLIGHT_WIDTHS = (64, 6, 2048, 1408)  # experts, top-k, D, I


def _routed_rows(routing: str, gen):
    """Token-expert pairs of ``routing`` in expert order at Moonlight's
    widths: ``uniform`` (1,000 tokens over all experts), ``skewed`` (90% of
    1,000 tokens favour experts 0-5), ``empty_experts`` (no odd expert gets a
    row), ``one_token`` (6 rows, no expert past one: every tile ragged)."""
    e, k, d, i = MOONLIGHT_WIDTHS
    tokens = 1 if routing == "one_token" else 1000
    scores = torch.rand(tokens, e, device="cuda", generator=gen)
    if routing == "skewed":
        scores[: int(0.9 * tokens), :k] += 1.0
    elif routing == "empty_experts":
        scores[:, 1::2] = -1.0
    order, offsets = dispatch(torch.topk(scores, k, dim=-1).indices, e)
    m = tokens * k
    xs = torch.randn(m, d, device="cuda", generator=gen).to(torch.bfloat16)
    w_gate_up = (torch.randn(e, 2 * i, d, device="cuda", generator=gen) * d**-0.5).to(torch.bfloat16)
    w_down = (torch.randn(e, d, i, device="cuda", generator=gen) * i**-0.5).to(torch.bfloat16)
    return xs, offsets, w_gate_up, w_down, torch.rand(m, device="cuda", generator=gen)


@pytest.mark.parametrize("routing", ["uniform", "skewed", "empty_experts", "one_token"])
def test_grouped_expert_kernels_match_plain(cuda, routing):
    """Both grouped launches at Moonlight's widths in bf16 against the plain
    per-expert loop: each element within one bf16 unit of its own value
    (the gated h and the expert's output round to bf16 after float32 sums
    in another order) beyond a thousandth of the largest; the same bits
    twice; two launches a call."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _routed_rows(routing, gen)
    if routing == "empty_experts":
        counts = args[1].diff()
        assert (counts[1::2] == 0).all() and (counts[::2] > 0).all()
    before = routed_experts.launches
    got = routed_experts(*args)
    assert routed_experts.launches == before + 2
    want = reference_routed_experts(*args)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    slack = 2.0**-7 * want.abs() + 1e-3 * want.abs().max()
    assert ((got - want).abs() <= slack).all(), (got - want).abs().max()
    assert torch.equal(routed_experts(*args), got)


def test_grouped_expert_kernels_refuse_what_they_do_not_take(cuda):
    xs, offsets, w_gate_up, w_down, pair_w = _routed_rows("one_token", torch.Generator(device="cuda").manual_seed(0))
    with pytest.raises(TypeError):
        routed_experts(xs.float(), offsets, w_gate_up.float(), w_down.float(), pair_w)
    with pytest.raises(ValueError):
        routed_experts(xs, offsets.long(), w_gate_up, w_down, pair_w)
    with pytest.raises(ValueError):
        cut = (xs[:, :1000].contiguous(), offsets, w_gate_up[..., :1000].contiguous(), w_down[:, :1000].contiguous())
        routed_experts(*cut, pair_w)


def test_a_moe_layer_on_the_card_waits_for_nothing(cuda):
    """One MoE block at Moonlight's widths over 3,000 tokens under
    ``set_sync_debug_mode("error")``: routing, dispatch, both grouped
    launches, the combine and the shared experts, with no wait for the
    device; its output equals the same block's plain path on the card (the
    per-expert loop) within a bf16 unit beyond a thousandth."""
    e, k, d, i = MOONLIGHT_WIDTHS
    block = MoEBlock(d, e, k, i, 2, 2.446, True)
    for t in block.parameters():
        t.data = torch.randn(t.shape) * (t.shape[-1] ** -0.5 if t.dim() > 1 else 0.02)
    block = block.to(cuda, torch.bfloat16).eval()
    x = torch.randn(3000, d, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = block(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with torch.no_grad():
        picked, weight = block.gate(x)
        order, offsets = dispatch(picked, e)
        y = reference_routed_experts(
            x.index_select(0, order // k), offsets, block.experts.gate_up_proj, block.experts.down_proj,
            weight.reshape(-1)[order].contiguous(),
        )
        slot = torch.empty_like(order)
        slot[order] = torch.arange(order.numel(), device=cuda)
        routed = sum(y[slot.view(-1, k)[:, j]] for j in range(k)).to(torch.bfloat16)
        sh = block.shared_experts
        want = routed + sh["down_proj"](F.silu(sh["gate_proj"](x)) * sh["up_proj"](x))
    assert ((got.float() - want.float()).abs() <= 2.0**-7 * want.float().abs() + 1e-3 * want.float().abs().max()).all()


def _moe_block(d, e, k, i, shared, held=None, seed=0):
    torch.manual_seed(seed)
    block = MoEBlock(d, e, k, i, shared, 2.446, True, held)
    for t in block.parameters():
        t.data = torch.randn(t.shape) * (t.shape[-1] ** -0.5 if t.dim() > 1 else 0.02)
    return block.to("cuda", torch.bfloat16).eval()


def test_a_moonlight_moe_layer_computes_as_before_the_expert_share(cuda):
    """Moonlight's MoE block (no share) on a fixed input equals, to the bit,
    the block as it computed before a block could hold a share of its
    experts: the same picks, the same grouped launches, the same combine."""
    e, k, d, i = MOONLIGHT_WIDTHS
    block = _moe_block(d, e, k, i, 2, seed=3)
    x = torch.randn(3000, d, device=cuda, generator=torch.Generator(device=cuda).manual_seed(4)).to(torch.bfloat16)
    with torch.no_grad():
        got = block(x)
        picked, weight = block.gate(x)
        order, offsets = dispatch(picked, e)
        y = routed_experts(x.index_select(0, order // k), offsets, block.experts.gate_up_proj,
                           block.experts.down_proj, weight.reshape(-1)[order])
        slot = torch.empty_like(order)
        slot[order] = torch.arange(order.numel(), device=cuda)
        slot = slot.view(-1, k)
        routed = y.index_select(0, slot[:, 0])
        for j in range(1, k):
            routed += y.index_select(0, slot[:, j])
        sh = block.shared_experts
        want = routed.to(torch.bfloat16) + F.linear(F.silu(F.linear(x, sh["gate_proj"].weight)) * F.linear(
            x, sh["up_proj"].weight), sh["down_proj"].weight)
    assert torch.equal(got, want)


KIMI_WIDTHS = (256, 8, 2304, 1024)  # experts, top-k, D, I


def test_a_moe_layer_holding_a_share_waits_for_nothing(cuda):
    """A MoE block at Kimi-Linear's widths holding experts 128-255 of 256,
    over 3,000 tokens under ``set_sync_debug_mode("error")``: routing over
    all 256, the held pairs dispatched first, both grouped launches ending
    at ``offsets[128]`` on the device, the combine of the held pairs and the
    shared expert, with no wait; its output equals the plain per-expert loop
    over the held experts within a bf16 unit beyond a thousandth."""
    e, k, d, i = KIMI_WIDTHS
    block = _moe_block(d, e, k, i, 1, held=(128, 128), seed=5)
    x = torch.randn(3000, d, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    before = routed_experts.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = block(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert routed_experts.launches == before + 2
    with torch.no_grad():
        picked, weight = block.gate(x)
        local, held = held_picks(picked, 128, 128)
        assert 0 < int(held.sum()) < held.numel()
        routed = torch.zeros(x.shape[0], d, device=cuda)
        for j in range(k):
            for ex in range(128):
                rows = torch.nonzero(held[:, j] & (local[:, j] == ex))[:, 0]
                if rows.numel():
                    offsets = torch.tensor([0, rows.numel()], dtype=torch.int32, device=cuda)
                    routed[rows] += reference_routed_experts(
                        x[rows], offsets, block.experts.gate_up_proj[ex : ex + 1],
                        block.experts.down_proj[ex : ex + 1], weight[rows, j].contiguous())
        sh = block.shared_experts
        want = routed.to(torch.bfloat16) + sh["down_proj"](F.silu(sh["gate_proj"](x)) * sh["up_proj"](x))
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).abs() <= 2.0**-7 * want.float().abs() + 1e-3 * want.float().abs().max()).all()


def _kda_inputs(lens, decay: str, gen, h=32, d=128):
    """A right-padded batch at KDA's widths: q, k L2-normalised (q scaled),
    log alpha of ``decay`` ``strong`` (-exp(A) softplus(f), exp(A) up to 16:
    a chunk's decays reach -1,000) or ``weak`` (near 0: the state carries
    across the row), beta in (0, 1)."""
    b, t = len(lens), max(lens)
    q = F.normalize(torch.randn(b, t, h, d, device="cuda", generator=gen), dim=-1) * d**-0.5
    k = F.normalize(torch.randn(b, t, h, d, device="cuda", generator=gen), dim=-1)
    v = torch.randn(b, t, h, d, device="cuda", generator=gen)
    if decay == "strong":
        a = torch.rand(h, device="cuda", generator=gen) * 15 + 1
        f = torch.randn(b, t, h, d, device="cuda", generator=gen)
        log_alpha = -a[:, None] * F.softplus(f)
    else:
        log_alpha = -torch.rand(b, t, h, d, device="cuda", generator=gen) * 1e-3
    beta = torch.rand(b, t, h, device="cuda", generator=gen)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return [x.to(torch.bfloat16) for x in (q, k, v)] + [log_alpha, beta, lens_t]


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_kda_kernel_matches_plain(cuda, decay):
    """The chunked KDA kernel at Kimi-Linear's widths (32 heads of 128) on a
    right-padded batch of rows of 1, 63, 64, 65, 1,000 and 4,096 tokens
    against the plain chunked version (float32 throughout) on the same bf16
    inputs: within a bf16 unit of each value (o rounds to bf16) beyond
    1e-3 of the largest (the kernel's products take TF32 operands); zeros
    past each row's length; one launch; the same bits twice."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = _kda_inputs([1, 63, 64, 65, 1000, 4096], decay, gen)
    before = kda.launches
    with torch.no_grad():
        got = kda(*args)
        assert kda.launches == before + 1
        want = reference_kda(*args[:5], args[5]).float()
    got = got.float()
    assert torch.isfinite(got).all() and want.abs().max() > 0
    err = (got - want).abs()
    assert (err <= 2.0**-7 * want.abs() + 1e-3 * want.abs().max()).all(), err.max()
    lens = args[5].tolist()
    for r, n in enumerate(lens):
        assert (got[r, n:] == 0).all()
    assert torch.equal(kda(*args).float(), got)


def test_kda_kernel_matches_the_per_token_recurrence(cuda):
    """The kernel against the recurrence one token at a time (float32) on
    rows of 200 and 131 tokens with strong decays, within the same
    tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, log_alpha, beta, lens = _kda_inputs([200, 131], "strong", gen, h=4)
    with torch.no_grad():
        got = kda(q, k, v, log_alpha, beta, lens).float()
        want = recurrent_kda(q, k, v, log_alpha, beta)
    want[1, 131:] = 0
    assert ((got - want).abs() <= 2.0**-7 * want.abs() + 1e-3 * want.abs().max()).all()


def test_kda_prep_and_gated_norm_kernels_match_plain(cuda):
    """KDA's two elementwise kernels at Kimi-Linear's widths (32 heads of
    128) on rows of 200 tokens against their plain versions on the card:
    q, k and v within one bf16 unit of each value (float32 inside, rounded
    once), log alpha within 1e-5 relative, the gated norm within one bf16
    unit beyond 1e-3 of the largest."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, t, h = 3, 200, 32
    inner = h * 128

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(torch.bfloat16)

    q_lin, k_lin, v_lin, f = (draw(b, t, inner) for _ in range(4))
    convs = [draw(inner, 1, 4, scale=0.5) for _ in range(3)]
    a_log = (torch.rand(h, device="cuda", generator=gen) * 15 + 1).log().to(torch.bfloat16)
    dt_bias = draw(inner)
    args = (q_lin, k_lin, v_lin, f, convs, a_log, dt_bias, h, 128**-0.5)
    got = kda_prep(*args)
    want = reference_kda_prep(*args)
    for g, w in zip(got[:3], want[:3]):
        assert g.is_contiguous() and g.shape == (b, t, h, 128)
        assert ((g.float() - w.float()).abs() <= 2.0**-7 * w.float().abs() + 1e-6).all()
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    o, gate = draw(b, t, h, 128), draw(b, t, inner)
    weight = 1 + 0.1 * torch.randn(128, device="cuda", generator=gen)
    got = kda_gated_norm(o, gate, weight, 1e-5).float()
    want = reference_gated_norm(o, gate, weight, 1e-5).float()
    assert ((got - want).abs() <= 2.0**-7 * want.abs() + 1e-3 * want.abs().max()).all()


SMALL_KIMI = {
    "architectures": ["KimiLinearForCausalLM"], "vocab_size": 101, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 5, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 8,
    "num_experts_per_token": 2, "num_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
    "num_expert_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000, "num_nextn_predict_layers": 0,
    "mla_use_nope": True,
    "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 128, "num_heads": 2,
                           "short_conv_kernel_size": 4},
}


def _small_kimi(device):
    cfg = encoder_config_from_hf(SMALL_KIMI, experts_held=(0, 4), param_dtype="bfloat16", compute_dtype="bfloat16")
    base = init_random_weights(NewsEncoder(cfg), 4).eval()
    enc = NewsEncoder(cfg).eval()
    enc.load_state_dict(base.state_dict())
    return base, enc.to(device)


def test_kimi_linear_encoder_on_cuda_matches_cpu(cuda):
    """A small Kimi Linear encoder (5 layers KDA, KDA, KDA, MLA, KDA, the
    first dense; KDA 2 heads of 128; 8 experts, top-2, 4 held) in bf16
    through ``encode_query_and_passage`` on the card and on the CPU: the
    KDA kernel and the grouped kernels launch on the card, and both tables
    agree within 2e-2 (bf16 products summed in other orders over five
    layers, the recurrence's products in TF32)."""
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 90, size=n)) for n in (3, 17, 9, 70, 1, 40, 120)]
    tok = HashTokenizer(vocab_size=101, max_length=160)
    base, enc = _small_kimi(cuda)
    before = (kda.launches, routed_experts.launches)
    got = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(32, 64), device=cuda)
    assert kda.launches > before[0] and routed_experts.launches > before[1]
    want = encode_query_and_passage(base, tok, texts, QUERY_INSTRUCTION, 4, buckets=(32, 64), device="cpu")
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2e-2)


def test_kimi_linear_encode_on_the_card_waits_for_nothing(cuda):
    """The small Kimi Linear encoder's bucketed ``encode_query_and_passage``
    under ``set_sync_debug_mode("error")``, once the kernels are built: KDA's
    lengths, the MLA, the shared MoE and the pools queue without a wait for
    the device; the tables equal the call's before it to the bit."""
    rng = np.random.default_rng(6)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 90, size=n)) for n in rng.integers(1, 100, size=12)]
    tok = HashTokenizer(vocab_size=101, max_length=128)
    _, enc = _small_kimi(cuda)
    want = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(32, 64), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(32, 64), device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


SMALL_MOONLIGHT = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "n_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 50000, "max_position_embeddings": 512,
}


def test_moonlight_encoder_on_cuda_matches_cpu(cuda):
    """A small DeepSeek-V3 encoder (3 layers, the first dense; 8 experts,
    top-2) in bf16 through ``encode_query_and_passage`` on the card and on
    the CPU: the grouped kernels launch on the card, and both tables agree
    within 2e-2 (bf16 products summed in other orders, over three layers)."""
    texts = [" ".join(f"w{j}" for j in range(n)) for n in (3, 17, 9, 30, 1, 12)]
    tok = HashTokenizer(vocab_size=101, max_length=40)
    cfg = encoder_config_from_hf(SMALL_MOONLIGHT, param_dtype="bfloat16", compute_dtype="bfloat16")
    base = init_random_weights(NewsEncoder(cfg), 4).eval()
    out = {}
    before = routed_experts.launches
    for dev in ("cpu", cuda):
        enc = NewsEncoder(cfg).eval()
        enc.load_state_dict(base.state_dict())
        enc.to(dev)
        tables = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(8, 16), device=dev)
        out[str(dev)] = [t.cpu() for t in tables]
    assert routed_experts.launches > before
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


def test_moonlight_encode_on_the_card_waits_for_nothing(cuda):
    """The small DeepSeek-V3 encoder's whole bucketed ``encode_query_and_passage``
    under ``set_sync_debug_mode("error")``, once the kernels are built: the
    host queues it all without a wait for the device, the short bucket's
    five batches of 4 rows (the cap) on the current stream and the long
    bucket's one small batch on the side stream (``SIDE_STREAM_TOKENS``) beside them. The tables
    equal the call's before it to the bit, and the CPU's within 2e-2."""
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(1, 6, size=20)] + [24, 30]
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 90, size=n)) for n in lens]
    tok = HashTokenizer(vocab_size=101, max_length=40)
    cfg = encoder_config_from_hf(SMALL_MOONLIGHT, param_dtype="bfloat16", compute_dtype="bfloat16")
    base = init_random_weights(NewsEncoder(cfg), 4).eval()
    cpu = encode_query_and_passage(base, tok, texts, QUERY_INSTRUCTION, 4, buckets=(8, 16), device="cpu")
    enc = NewsEncoder(cfg).eval()
    enc.load_state_dict(base.state_dict())
    enc.to(cuda)
    want = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(8, 16), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, 4, buckets=(8, 16), device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w)
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=2e-2)


def test_query_table_step_on_cuda_matches_cpu(cuda):
    """The flat margin step reading its histories from a query table that
    differs from the passage table: the loss within 1e-6 and the gradients
    within a norm-relative 1e-5 of the CPU, and unlike the step that reads
    the passage table."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=80, num_rows=120, dim=64, noise=0.05, seed=3)
    c = compile_behaviors(imps, hist).with_history_view()
    news = align_embeddings(c.news_ids, emb)
    q = news + 0.7 * np.random.default_rng(1).standard_normal(news.shape).astype(np.float32)
    query = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    tower = build_tower(SMALL_TOWER)
    trainer = TowerTrainer(tower, c, news, cfg=TrainConfig(batch_size=64, seed=0), device="cpu")
    batch = next(iter(trainer._epoch_batches_flat()))
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(0), SMALL_TOWER))
    results = []
    for dev in ("cpu", cuda):
        t = build_tower(SMALL_TOWER)
        t.load_state_dict(state)
        t.to(dev)
        args = (torch.from_numpy(news).to(dev), tuple(torch.from_numpy(a).to(dev) for a in batch))
        loss = flat_margin_loss(t, *args, 2.0, query_emb=torch.from_numpy(query).to(dev))
        loss.backward()
        results.append((loss.item(), [p.grad.cpu() for p in t.parameters()]))
        with torch.no_grad():
            assert abs(flat_margin_loss(t, *args, 2.0).item() - loss.item()) > 1e-4
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    assert l_gpu == pytest.approx(l_cpu, abs=1e-6)
    num = math.sqrt(sum(float((a - b).pow(2).sum()) for a, b in zip(g_gpu, g_cpu)))
    den = math.sqrt(sum(float(b.pow(2).sum()) for b in g_cpu))
    assert num <= 1e-5 * den


def test_train_cli_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """``nrtorch-train`` at ``--dim 64``, one epoch of each trainer, on the
    card and with ``--device cpu``, from id-keyed dumps of d=64 passage and
    query tables: the train and dev metrics within 1e-4, the trained
    tower's weights within a norm-relative 1e-4."""
    from news_recommendation_project_v2_torch.cli import ingest as ingest_cli
    from news_recommendation_project_v2_torch.cli import train as train_cli
    from news_recommendation_project_v2_torch.ops.encode import save_embeddings
    from news_recommendation_project_v2_torch.train.checkpoint import load_pytree

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    ids = np.array([f"N{i}" for i in range(60)])
    tables = [rng.standard_normal((60, 64)).astype(np.float32) for _ in range(2)]
    tables = [t / np.linalg.norm(t, axis=1, keepdims=True) for t in tables]
    for name in ("MINDsmall_train", "MINDsmall_dev"):
        ingest_cli.main([str(tmp_path), name, "--synthetic"])
        save_embeddings(tmp_path / "emb", name, *tables, news_ids=ids)
    runs = {}
    for dev in ("cpu", "cuda"):
        _, train_ctx, dev_ctx = train_cli.main(
            [str(tmp_path), "--emb-dir", str(tmp_path / "emb"), "--dim", "64", "--epochs", "1", "--cls-epochs", "1",
             "--batch-size", "32", "--no-cache", "--ckpt-dir", str(tmp_path / dev), "--log-dir", str(tmp_path / "logs"),
             "--device", dev]
        )
        runs[dev] = train_ctx["metrics"], dev_ctx["metrics"], load_pytree(tmp_path / dev / "attention" / "Epoch_1")
    for split in (0, 1):
        for k in ("auc", "mrr", "ndcg5", "ndcg10"):
            assert runs["cuda"][split][k] == pytest.approx(runs["cpu"][split][k], abs=1e-4)
    a, b = runs["cuda"][2], runs["cpu"][2]
    num = math.sqrt(sum(float((a[k] - b[k]).pow(2).sum()) for k in b))
    den = math.sqrt(sum(float(b[k].pow(2).sum()) for k in b))
    assert num <= 1e-4 * den


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """Both synthetic MIND splits through ``nrtorch-ingest``, ``nrtorch-save-emb
    --tiny-encoder`` and ``nrtorch-train --dim 128`` (one epoch each) on the
    card: the dumps and the checkpoint the eval and serve CLIs load."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from news_recommendation_project_v2_torch.cli import ingest as ingest_cli
    from news_recommendation_project_v2_torch.cli import save_emb as save_emb_cli
    from news_recommendation_project_v2_torch.cli import train as train_cli

    root = tmp_path_factory.mktemp("mind")
    for name in ("MINDsmall_train", "MINDsmall_dev"):
        ingest_cli.main([str(root), name, "--synthetic"])
        save_emb_cli.main([str(root), name, "--save-dir", str(root / "emb"), "--tiny-encoder", "--max-length", "24",
                           "--batch-size", "16"])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        train_cli.main([str(root), "--emb-dir", str(root / "emb"), "--dim", "128", "--epochs", "1", "--cls-epochs", "1",
                        "--batch-size", "32", "--no-cache", "--log-dir", str(root / "logs"), "--ckpt-dir",
                        str(root / "models")])
    return root


CLI_CKPT = Path("models") / "attention" / "Best_model_e5_query_latent"


def test_eval_cli_on_cuda_matches_the_direct_flat_eval(cuda, cli_root):
    """``nrtorch-eval --ckpt`` on the card over the dev split's with-history
    rows: its metrics within 1e-5 of the flat eval and the metrics on the
    card computed directly from the same checkpoint and tables."""
    from news_recommendation_project_v2_torch.cli import eval as eval_cli
    from news_recommendation_project_v2_torch.cli.common import build_context
    from news_recommendation_project_v2_torch.config import DataSubset, NewsDataset
    from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
    from news_recommendation_project_v2_torch.ops.encode import load_embeddings
    from news_recommendation_project_v2_torch.pipeline import TransformDataComponent
    from news_recommendation_project_v2_torch.train.checkpoint import load_pytree

    ckpt = cli_root / CLI_CKPT
    ctx = eval_cli.main([str(cli_root), "--dataset", "MINDsmall_dev", "--emb-dir", str(cli_root / "emb"), "--ckpt",
                         str(ckpt), "--dim", "128", "--log-dir", str(cli_root / "logs")])
    compiled = TransformDataComponent().transform(
        build_context(cli_root, NewsDataset.MINDsmall_dev, data_subset=DataSubset.WITH_HISTORY)
    )["compiled"]
    emb, query = load_embeddings(cli_root / "emb", "MINDsmall_dev", with_query=True, align_to_news_ids=compiled.news_ids)
    tower = build_tower(TowerConfig(kind="latent", **tower_kwargs_for_dim(128)))
    tower.load_state_dict(load_pytree(ckpt))
    slots, rows = history_candidate_slots(compiled)
    view = compiled.with_history_view()
    plan = FlatEvalPlan(view.hist_rev, view.hist_lens, compiled.imp_rev[slots], rows, max_len=600, device=cuda)
    mplan = DeviceMetricsPlan(compiled.imp_lens, compiled.labels_flat, hist_slots=slots, device=cuda)
    direct = plan.metrics(tower.to(cuda), emb, mplan, query_news_emb=query)
    for k in METRIC_KEYS:
        assert abs(ctx["metrics"][k] - direct[k]) <= 1e-5, k


def test_serve_cli_on_cuda_answers_a_post(cuda, cli_root):
    """``nrtorch-serve --ckpt`` in its own process on the card answers a
    ``POST /rank``: the request's candidates, scores finite and descending,
    within 1e-5 of ``build_ranker`` over the same dump and checkpoint in
    this process."""
    ckpt = cli_root / CLI_CKPT
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ids = [str(n) for n in np.load(cli_root / "emb" / "MINDsmall_dev_ids.npy")]
    hist, cands = ids[:20], ids[20:40]
    repo = Path(__file__).resolve().parents[1]
    with open(cli_root / "serve.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "news_recommendation_project_v2_torch.cli.serve", str(cli_root / "emb"),
             "MINDsmall_dev", "--ckpt", str(ckpt), "--dim", "128", "--port", str(port)],
            cwd=repo, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            deadline = time.monotonic() + 180
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5):
                        break
                except OSError:
                    assert proc.poll() is None and time.monotonic() < deadline, (cli_root / "serve.log").read_text()
                    time.sleep(0.5)
            ranked = _post(port, "rank", {"history": hist, "candidates": cands})["ranked"]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    _check_ranked(ranked, cands)
    cfg = TowerConfig(kind="latent", **tower_kwargs_for_dim(128))
    want = dict(build_ranker(cli_root / "emb", "MINDsmall_dev", ckpt, cfg, device=cuda).rank(hist, cands))
    assert max(abs(s - want[c]) for c, s in ranked) <= 1e-5


def test_reproduce_and_train_e2e_clis_on_cuda(cuda, tmp_path):
    """``nrtorch-reproduce --synthetic --tiny-encoder --with-e2e`` on the card
    gives configs 0-2's rows with MIND metrics in [0, 1]; then
    ``nrtorch-train-e2e --dim 32`` on its data gives finite metrics."""
    from news_recommendation_project_v2_torch.cli import reproduce as reproduce_cli
    from news_recommendation_project_v2_torch.cli import train_e2e as train_e2e_cli

    rows = reproduce_cli.main([str(tmp_path), "--synthetic", "--tiny-encoder", "--epochs", "1", "--with-e2e",
                               "--max-length", "24", "--out", str(tmp_path / "rows.json")])
    assert [r["config"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r[k]) and 0 <= r[k] <= 1 for r in rows for k in METRIC_KEYS)
    ctx = train_e2e_cli.main([str(tmp_path), "--epochs", "1", "--dim", "32", "--max-length", "24", "--log-dir",
                              str(tmp_path / "logs_e2e"), "--ckpt-dir", str(tmp_path / "models_e2e")])
    assert all(np.isfinite(ctx["metrics"][k]) for k in METRIC_KEYS)


@pytest.mark.parametrize("backend,ranks", [("gloo", 2), ("nccl", 1)], ids=["gloo_two_ranks", "nccl_one_rank"])
def test_data_parallel_steps_on_cuda(cuda, backend, ranks):
    """The data-parallel steps on the card (``parallel.mesh.launch``, rank
    code in ``torch_mesh_workers``): two ranks sharing the card over gloo
    with CUDA tensors (NCCL refuses two ranks on one GPU), and NCCL's world
    of one; each step against one rank's at the same weights (loss 1e-6,
    gradient norm-relative 1e-5), the ranks' weights equal to the bit."""
    import torch_mesh_workers as workers

    from news_recommendation_project_v2_torch.parallel import launch

    out = launch(workers.cuda_worker, ranks, args=(workers.numpy_params(), backend), backend=backend, timeout=600)
    for rank in out:
        assert rank["backend"] == backend and rank["shape"] == {"data": ranks, "model": 1}
        for kind, got in rank["steps"].items():
            assert got["steps"] == 3 and got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-5, (kind, got)
            for k, v in got["params"].items():
                assert np.array_equal(v, out[0]["steps"][kind]["params"][k]), (kind, k)


def test_native_compiler_on_the_cards_machine(cuda):
    """The native behaviors compiler builds with the machine's g++ and
    Python headers and gives the numpy path's arrays (``compile_native``
    raises rather than fall back to numpy)."""
    from news_recommendation_project_v2_torch import native

    assert native.load() is not None
    rng = np.random.default_rng(0)
    imps = [" ".join(f"N{j}-{int(j % 3 == 0)}" for j in rng.choice(500, 12, replace=False)) for _ in range(2000)]
    hist = [" ".join(f"N{j}" for j in rng.choice(500, 20)) if i % 5 else None for i in range(2000)]
    a, b = compile_native(imps, hist), compile_behaviors(imps, hist, use_native=False)
    assert a.news_ids.tolist() == b.news_ids.tolist()
    for field in ("imp_rev", "imp_row", "imp_lens", "hist_rev", "hist_row", "hist_lens", "hist_row_index", "labels_flat"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


MESH2_ROUTES = [*(f"e2e_{r}" for r in ("streamed", "replicated", "sharded", "sharded_infonce")), "materialize",
                "sharded_store", "sequence_tower", "sharded_encode", "tp_bert", "tp_nv_embed", "ranker"]


@pytest.fixture(scope="module", params=[("gloo", 2), ("nccl", 1)], ids=["gloo_two_ranks", "nccl_one_rank"])
def mesh2_cuda(request):
    """Multi-GPU part 2 on the card (``parallel.mesh.launch``, rank code in
    ``torch_mesh_workers.cuda_part2_worker``): two gloo ranks sharing the
    card on mesh (1, 2), or NCCL's world of one; each route next to one
    device's result on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    import torch_mesh_workers as workers
    from news_recommendation_project_v2_torch.parallel import launch

    backend, ranks = request.param
    return launch(workers.cuda_part2_worker, ranks, args=(backend,), backend=backend, timeout=900)


@pytest.mark.parametrize("route", MESH2_ROUTES)
def test_mesh_part_two_on_cuda(mesh2_cuda, route):
    """The CPU tests' tolerances (``tests/test_torch_mesh_{e2e,encode,serve}.py``)
    against one device on the card; the ranks' weights equal to the bit."""
    ranks = mesh2_cuda
    assert all(r["backend"] == ("gloo" if len(ranks) == 2 else "nccl") for r in ranks)
    for r in ranks:
        if route.startswith("e2e_"):
            got = r["steps"][route[4:]]
            assert got["steps"] == 3 and got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-5, got
            for k, v in got["params"].items():
                assert np.array_equal(v, ranks[0]["steps"][route[4:]]["params"][k]), k
        elif route == "materialize":
            assert max(r["materialize"].values()) <= 1e-5, r["materialize"]
        elif route == "sharded_store":
            assert r["store"]["shard_equal"] and r["store"]["gather_equal"]
        elif route == "sequence_tower":
            assert r["forward"]["seq_latent"] <= 1e-5
        elif route == "sharded_encode":
            assert r["forward"]["encode"] <= 1e-5
        elif route.startswith("tp_"):
            assert r["forward"][route] <= 1e-5 and r["forward"]["split"][route]
        else:
            if r["serve"].get("served") is not None:
                assert r["serve"]["served"] > 0
                continue
            for call, answers in r["serve"].items():
                for got, want in zip(answers, r["serve_single"][call]):
                    assert [c for c, _ in got] == [c for c, _ in want], call
                    g = np.array([s for _, s in got])
                    w = np.array([s for _, s in want])
                    finite = np.isfinite(w)
                    assert np.array_equal(np.isfinite(g), finite)
                    assert np.abs(g[finite] - w[finite]).max(initial=0.0) <= 1e-5, call
