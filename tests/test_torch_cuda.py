"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs, forward and, under autograd, backward; the tower,
the flat eval and the train step on the card against the same on the CPU;
determinism and host syncs. Every test here skips without CUDA.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so there run
it without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
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
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan
from news_recommendation_project_v2_torch.ops.timing import count_syncs
from news_recommendation_project_v2_torch.train.step import (
    flat_infonce_loss,
    flat_infonce_step,
    flat_margin_loss,
    flat_margin_step,
)
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer, make_optimizer

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


def _attention_tol(want, dtype):
    """Both sum in float32 (the kernel's products as 3xTF32, float32-accurate);
    a bfloat16 output may round one unit apart."""
    return 1e-5 if dtype == torch.float32 else 2**-8 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_planner_shared_memory_matches_the_kernel(cuda, dtype):
    """The planner's ``attention_smem`` is the CUDA source's own layout for
    every block shape and N, so the planner never picks a shape the launcher
    refuses nor passes over one that fits."""
    for rows in ROWS:
        for n in range(1, MAX_N + 1):
            assert attention_smem(rows, n, dtype) == kernel_smem(rows, n, dtype), (rows, n)
    assert kernel_smem(48, 64, dtype) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [(37, 1024, 4096), (16, 1024, 4096), (512, 1024, 4096), (37, 1536, 6144), (300, 96, 130)],
    ids=["request", "c16", "c512", "wide_d", "unaligned"],
)
def test_geglu_kernel_matches_plain(cuda, dtype, shape):
    """float32 runs as 3xTF32, whose products are float32-accurate, summed in
    another order over up to 6,144 + 1,536 terms: 1e-4. In bfloat16 the
    gated product may round one bfloat16 unit apart from the plain
    version's: 1e-3. (300, 96, 130) has F not a multiple of 4, so W_out's
    rows are not 16-byte aligned and take the kernel's masked loads."""
    args = _geglu_args(shape, dtype, cuda)
    before = geglu.launches, geglu.shapes[shape]
    got = geglu(*args)
    torch.cuda.synchronize()
    assert (geglu.launches, geglu.shapes[shape]) == (before[0] + 1, before[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 100, 36), (130, 200, 520)])
def test_geglu_kernel_takes_ragged_edges(cuda, dtype, shape):
    """One row and one column; a D that ends inside a pipeline stage, whose
    staged rows are zero past D; C past a tile and F past a gate block. Same
    tolerances and reasons as above."""
    args = _geglu_args(shape, dtype, cuda)
    got = geglu(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(got, reference_geglu(*args), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_kernel_is_deterministic(cuda, dtype):
    """Split F sums are added in a fixed order, with no atomics: the same
    inputs give the same bits on two launches (C=37 splits pass B 8 ways)."""
    args = _geglu_args((37, 1024, 4096), dtype, cuda)
    first = geglu(*args)
    second = geglu(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


SMALL_TOWER = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)


def _train_batch(rng, b=48, k=5, news=300):
    """A flat batch as TowerTrainer builds one: deduped rows' tokens padded to
    1,024 (pad row b), pad pairs, -1 negatives."""
    lens = rng.integers(1, 40, 30)
    total = int(lens.sum())
    tok_rows = np.full(1024, b, np.int32)
    tok_rows[:total] = np.repeat(np.arange(30), lens)
    neg = rng.integers(0, news, (b, k)).astype(np.int32)
    neg[rng.random((b, k)) < 0.2] = -1
    return (
        rng.integers(0, news, 1024).astype(np.int32), tok_rows, np.pad(lens, (0, b - 30)).astype(np.float32),
        np.pad(rng.integers(0, 30, 40), (0, b - 40)).astype(np.int32),
        np.pad(rng.integers(0, news, 40), (0, b - 40)).astype(np.int32), neg,
        np.pad(np.ones(40, np.float32), (0, b - 40)),
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
    """FlatEvalPlan on the card (both kernels, every chunk) against the same
    plan on the CPU (plain versions); its metrics against DeviceMetricsPlan
    over its own scores."""
    w = _flat_world(cfg)
    chunks = dict(chunk_tokens=256, cand_chunk=128)
    before = latent_attention.launches, geglu.launches
    plan = FlatEvalPlan(*w["hist"], device=cuda, **chunks)
    got = plan.score(_flat_tower(cfg, w["state"], cuda), w["emb"])
    n_chunks = len(plan.history.chunks)
    assert n_chunks > 3
    assert (latent_attention.launches, geglu.launches) == (before[0] + n_chunks, before[1] + n_chunks)
    want = FlatEvalPlan(*w["hist"], device="cpu", **chunks).score(_flat_tower(cfg, w["state"], "cpu"), w["emb"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mplan = DeviceMetricsPlan(w["imp_lens"], w["labels"], hist_slots=np.arange(len(got)), device=cuda)
    m = plan.metrics(_flat_tower(cfg, w["state"], cuda), w["emb"], mplan)
    direct = mplan.compute(got)
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert abs(m[key] - direct[key]) <= 1e-6, key


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
