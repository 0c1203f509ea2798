"""The port's flat eval (``ops.scoring``) against the JAX package's on the same
numpy-seeded weights, tables and workload, on the CPU (where the port's
kernel wrappers compute their plain versions); and the helpers it needs
(``data.grouping``, ``utils.memory``) against their JAX originals."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.data import grouping as jax_grouping
from news_recommendation_project_v2_tpu.eval.device_metrics import (
    DeviceMetricsPlan as JaxMetricsPlan,
)
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops import scoring as jax_scoring
from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.data import grouping
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
)
from news_recommendation_project_v2_torch.ops import scoring
from news_recommendation_project_v2_torch.utils import memory
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SMALL = dict(reduced_dim=32, embedding_dim=32, num_latents=4, num_heads=2, latent_dim_head=8)
NUM_ROWS, NUM_NEWS = 24, 60
CHUNKS = dict(chunk_tokens=32, cand_chunk=16)  # rows straddle chunks, grids pad


def _mind_workload(rng, num_rows, num_news):
    """bench.py's MIND-like eval workload at another size, its draws in its
    order: geometric histories (mean 33, capped at 600), Poisson(37)
    candidates clipped to 2-300, click labels with one positive first and one
    negative last an impression. Returns (hist_lens, imp_lens, hist_rev,
    cand_rev, cand_row, labels)."""
    hist_lens = np.minimum(rng.geometric(1.0 / 33, size=num_rows), 600).astype(np.int32)
    imp_lens = np.clip(rng.poisson(37, size=num_rows), 2, 300).astype(np.int32)
    hist_rev = rng.integers(0, num_news, size=int(hist_lens.sum())).astype(np.int32)
    cand_rev = rng.integers(0, num_news, size=int(imp_lens.sum())).astype(np.int32)
    cand_row = np.repeat(np.arange(num_rows, dtype=np.int32), imp_lens)
    labels = (rng.random(len(cand_rev)) < 0.2).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(imp_lens)])
    labels[offsets[:-1]] = 1.0
    labels[offsets[1:] - 1] = 0.0
    return hist_lens, imp_lens, hist_rev, cand_rev, cand_row, labels


def _towers(cfg_kwargs, seed=3, compute_dtype="float32"):
    """The port's tower and the JAX tower's apply (output float32) on one
    set of weights; bfloat16 casts every parameter, as bench.py does."""
    cfg = TowerConfig(kind="latent", compute_dtype=compute_dtype, **cfg_kwargs)
    params = random_latent_params(np.random.default_rng(seed), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(latent_state_dict_from_jax(params), strict=True)
    jt = jax_build_tower(JaxTowerConfig(kind="latent", compute_dtype=compute_dtype, **cfg_kwargs))
    if compute_dtype == "bfloat16":
        tower = tower.to(torch.bfloat16)
        params = {"params": {k: _tree_bf16(v) for k, v in params["params"].items()}}
    return tower, (lambda p, e, m: jt.apply(p, e, m).astype(jnp.float32)), params


def _tree_bf16(v):
    return {k: _tree_bf16(x) for k, x in v.items()} if isinstance(v, dict) else jnp.asarray(v, jnp.bfloat16)


@pytest.fixture(scope="module")
def world():
    """A scaled-down MIND-like workload (``_mind_workload``), a news table and
    a second query table."""
    rng = np.random.default_rng(11)
    hist_lens, imp_lens, hist_rev, cand_rev, cand_row, labels = _mind_workload(rng, NUM_ROWS, NUM_NEWS)
    emb = rng.standard_normal((NUM_NEWS, 32)).astype(np.float32)
    query = (emb * 0.5 + rng.standard_normal(emb.shape) * 0.3).astype(np.float32)
    tower, apply, params = _towers(SMALL)
    return dict(
        hist_lens=hist_lens, imp_lens=imp_lens, hist_rev=hist_rev, cand_rev=cand_rev,
        cand_row=cand_row, labels=labels, emb=emb, query=query,
        tower=tower, apply=apply, params=params,
    )


def test_workload_straddles_chunks(world):
    ends = np.cumsum(world["hist_lens"])
    starts = ends - world["hist_lens"]
    assert (starts // 32 != (ends - 1) // 32).sum() >= 3
    assert ends[-1] % 32 and len(world["cand_rev"]) % 16


@pytest.mark.parametrize("max_len", [None, 5], ids=["all_tokens", "max_len5"])
@pytest.mark.parametrize("separate_query", [False, True], ids=["one_table", "query_table"])
def test_flat_plan_score_matches_jax(world, max_len, separate_query):
    w = world
    query = w["query"] if separate_query else None
    plan = scoring.FlatEvalPlan(
        w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"], max_len=max_len,
        device="cpu", **CHUNKS,
    )
    got = plan.score(w["tower"], torch.from_numpy(w["emb"]), query_news_emb=query)
    ref = jax_scoring.FlatEvalPlan(
        w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"], max_len=max_len, **CHUNKS
    )
    want = ref.score(w["apply"], w["params"], jnp.asarray(w["emb"]), query_news_emb=query)
    assert got.shape == want.shape == (len(w["cand_rev"]),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("max_len", [None, 5], ids=["all_tokens", "max_len5"])
def test_user_vectors_flat_matches_jax(world, max_len):
    w = world
    got = scoring.user_vectors_flat(
        w["tower"], w["query"], w["hist_rev"], w["hist_lens"], chunk_tokens=32,
        max_len=max_len, device="cpu",
    )
    want = jax_scoring.user_vectors_flat(
        w["apply"], w["params"], jnp.asarray(w["query"]), w["hist_rev"], w["hist_lens"],
        out_dim=32, chunk_tokens=32, max_len=max_len,
    )
    assert got.shape == (NUM_ROWS, 32) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_score_all_impressions_flat_is_the_plan(world):
    w = world
    args = (w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"])
    got = scoring.score_all_impressions(w["tower"], w["emb"], *args, flat_tokens=True, device="cpu")
    chunk = scoring._auto_flat_chunk(w["tower"].dim, int(w["hist_lens"].sum()), torch.device("cpu"))
    plan = scoring.FlatEvalPlan(*args, chunk_tokens=chunk, device="cpu")
    np.testing.assert_array_equal(got, plan.score(w["tower"], w["emb"]))


def test_flat_plan_bf16_matches_jax(world):
    """The tower in bfloat16 as bench.py runs it (every parameter cast, a
    bfloat16 query table, the cosine in float32): a norm-relative 3e-2, since
    the two frameworks round to bfloat16 at different points."""
    w = world
    tower, apply, params = _towers(SMALL, compute_dtype="bfloat16")
    args = (w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"])
    plan = scoring.FlatEvalPlan(*args, device="cpu", **CHUNKS)
    got = plan.score(tower, w["emb"], query_news_emb=torch.from_numpy(w["emb"]).bfloat16())
    want = jax_scoring.FlatEvalPlan(*args, **CHUNKS).score(
        apply, params, jnp.asarray(w["emb"]), query_news_emb=jnp.asarray(w["emb"], jnp.bfloat16)
    )
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2


METRIC_CASES = {
    "overwrite": (dict(), None),
    "baseline_alpha": (dict(alpha=0.3, baseline=True), None),
    "alpha_override": (dict(alpha=0.3, baseline=True), 0.8),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_flat_plan_metrics_matches_jax(world, case):
    """``FlatEvalPlan.metrics`` (the eval and the device metrics, five
    scalars fetched) against the JAX package's, with and without a baseline
    and a blend weight, and with the weight passed as a tensor at call time."""
    w = world
    kwargs, override = METRIC_CASES[case]
    plan_kwargs = dict(hist_slots=np.arange(len(w["cand_rev"])), row_chunk=8)
    if kwargs.get("baseline"):
        plan_kwargs["baseline_slots"] = np.random.default_rng(5).random(len(w["cand_rev"])).astype(np.float32)
        plan_kwargs["alpha"] = kwargs["alpha"]
    args = (w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"])
    mplan = DeviceMetricsPlan(w["imp_lens"], w["labels"], device="cpu", **plan_kwargs)
    got = scoring.FlatEvalPlan(*args, device="cpu", **CHUNKS).metrics(
        w["tower"], w["emb"], mplan, alpha=None if override is None else torch.tensor(override)
    )
    want = jax_scoring.FlatEvalPlan(*args, **CHUNKS).metrics(
        w["apply"], w["params"], jnp.asarray(w["emb"]), JaxMetricsPlan(w["imp_lens"], w["labels"], **plan_kwargs),
        alpha=None if override is None else jnp.asarray(override),
    )
    assert got["num_samples"] == want["num_samples"] == NUM_ROWS
    for k in ("auc", "mrr", "ndcg5", "ndcg10"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)


def test_flat_user_vectors_equal_the_padded_tower(world):
    """The flat pool is the tower's own masked pool: the flat user vectors
    equal the tower over padded, masked histories (the serving path)."""
    w = world
    lens = w["hist_lens"]
    flat = scoring.user_vectors_flat(w["tower"], w["emb"], w["hist_rev"], lens, chunk_tokens=32, device="cpu")
    ends = np.cumsum(lens)
    L = int(lens.max())
    idx = np.zeros((NUM_ROWS, L), np.int64)
    mask = np.zeros((NUM_ROWS, L), np.float32)
    for r in range(NUM_ROWS):
        idx[r, : lens[r]] = w["hist_rev"][ends[r] - lens[r] : ends[r]]
        mask[r, : lens[r]] = 1.0
    gathered = torch.from_numpy(w["emb"][idx] * mask[..., None])
    with torch.no_grad():
        padded = w["tower"](gathered, torch.from_numpy(mask))
    np.testing.assert_allclose(flat.numpy(), padded.numpy(), atol=1e-5)


def test_normalize_and_devices_must_agree(world):
    w = world
    plan = scoring.FlatEvalPlan(w["hist_rev"], w["hist_lens"], w["cand_rev"], w["cand_row"], device="cpu", **CHUNKS)
    with pytest.raises(ValueError, match="output_normalize"):
        plan.score(w["tower"], w["emb"], normalize=False)
    assert np.array_equal(plan.score(w["tower"], w["emb"], normalize=True), plan.score(w["tower"], w["emb"]))


def test_full_width_flat_matches_jax():
    """D=1024, 64 latents, 8 heads x 512, a handful of rows of about 40
    tokens (one of one token, one of none), three token chunks: within
    1e-4."""
    rng = np.random.default_rng(2)
    full = dict(reduced_dim=1024, embedding_dim=1024, num_latents=64, num_heads=8, latent_dim_head=512)
    tower, apply, params = _towers(full, seed=4)
    hist_lens = np.array([40, 37, 45, 1, 0, 42], np.int32)
    imp_lens = np.array([5, 3, 7, 2, 2, 4], np.int32)
    hist_rev = rng.integers(0, 50, int(hist_lens.sum())).astype(np.int32)
    cand_rev = rng.integers(0, 50, int(imp_lens.sum())).astype(np.int32)
    cand_row = np.repeat(np.arange(6, dtype=np.int32), imp_lens)
    emb = (rng.standard_normal((50, 1024)) * 0.05).astype(np.float32)
    args = (hist_rev, hist_lens, cand_rev, cand_row)
    got = scoring.FlatEvalPlan(*args, chunk_tokens=64, cand_chunk=8, device="cpu").score(tower, emb)
    want = jax_scoring.FlatEvalPlan(*args, chunk_tokens=64, cand_chunk=8).score(apply, params, jnp.asarray(emb))
    np.testing.assert_allclose(got, want, atol=1e-4)


# -- host helpers ----------------------------------------------------------------


@pytest.mark.parametrize("max_len", [1, 3, 8, 100])
def test_truncate_and_offsets_match_jax(max_len):
    rng = np.random.default_rng(max_len)
    lens = rng.integers(0, 9, size=30)
    flat = rng.integers(0, 1000, size=int(lens.sum()))
    got = grouping.truncate_flat_end_aligned(flat, lens, max_len)
    want = jax_grouping.truncate_flat_end_aligned(flat, lens, max_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(grouping.lengths_to_offsets(lens), jax_grouping.lengths_to_offsets(lens))
    assert grouping.lengths_to_offsets(lens).dtype == np.int64


ESTIMATOR_CONFIGS = {
    "full_f32": dict(),
    "full_bf16": dict(compute_dtype="bfloat16"),
    "small": SMALL,
}


H100_BYTES = 80 * 10**9  # about an H100 80GB's memory


@pytest.mark.parametrize("budget", [16 * 1024**3, H100_BYTES])
@pytest.mark.parametrize("name", list(ESTIMATOR_CONFIGS))
def test_memory_estimators_match_jax(name, budget):
    """For one explicit budget (16 GiB; about an H100's memory) the port's
    flat-chunk and metric-row estimators are the JAX package's."""
    cfg = TowerConfig(kind="latent", **ESTIMATOR_CONFIGS[name])
    jcfg = JaxTowerConfig(**dataclasses.asdict(cfg))
    assert memory.flat_token_bytes(cfg) == jax_memory.flat_token_bytes(jcfg)
    assert memory.estimate_flat_chunk(cfg, hbm_budget_bytes=budget) == jax_memory.estimate_flat_chunk(
        jcfg, hbm_budget_bytes=budget
    )
    for max_len in (1, 64, 300, 5000):
        assert memory.estimate_metric_rows(max_len, hbm_budget_bytes=budget) == jax_memory.estimate_metric_rows(
            max_len, hbm_budget_bytes=budget
        )


def test_flat_chunk_on_an_h100():
    """An H100 80GB: 262,144 tokens in float32 and 524,288 in bfloat16, the
    chunk at which the attention's q holds 2^31 elements."""
    assert memory.estimate_flat_chunk(TowerConfig(), hbm_budget_bytes=H100_BYTES) == 1 << 18
    bf16 = memory.estimate_flat_chunk(TowerConfig(compute_dtype="bfloat16"), hbm_budget_bytes=H100_BYTES)
    assert bf16 == 1 << 19 and bf16 * 8 * 512 == 2**31
