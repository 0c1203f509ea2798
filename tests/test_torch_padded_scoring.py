"""The port's bucketed (padded) eval path (``ops.scoring``: ``_bucket_plan``,
``user_vectors_bucketed``, ``score_all_impressions``, with
``data.grouping.gather_end_aligned`` and the padded memory estimators)
against the JAX package's, on the CPU, for every user tower; the latent
tower's padded scores against the port's own flat ones; and
``configs.run_config0``."""

import dataclasses

import numpy as np
import pytest

from news_recommendation_project_v2_tpu import configs as jax_configs
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.data import grouping as jax_grouping
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops import scoring as jax_scoring
from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.configs import run_config0
from news_recommendation_project_v2_torch.data import grouping
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import random_tower_params, tower_state_dict_from_jax
from news_recommendation_project_v2_torch.ops import scoring
from news_recommendation_project_v2_torch.utils import memory
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D, NUM_NEWS, ROWS = 32, 120, 40
BUCKETS = (4, 8, 16)  # small buckets, so that rows of up to 23 clicks meet every case, the cap included
CFGS = {
    "latent": TowerConfig(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, num_heads=2, latent_dim_head=16),
    "final_attention": TowerConfig(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=64, dropout_rate=0.0),
    "transformer": TowerConfig(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=1, dropout_rate=0.0),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    hist_lens = rng.integers(1, 24, ROWS)
    hist_lens[:3] = (1, 16, 23)
    hist_rev = rng.integers(0, NUM_NEWS, hist_lens.sum())
    cand_row = np.sort(rng.integers(0, ROWS, 300)).astype(np.int32)
    cand_rev = rng.integers(0, NUM_NEWS, 300)
    emb = rng.standard_normal((NUM_NEWS, D)).astype(np.float32)
    return hist_rev, hist_lens, cand_rev, cand_row, emb


def test_gather_end_aligned_equals_jax():
    """Windows shorter and longer than the width, extra pad rows, no rows."""
    rng = np.random.default_rng(3)
    lens = np.array([1, 5, 9, 3, 12])
    flat = rng.integers(0, 50, lens.sum())
    ends = grouping.lengths_to_offsets(lens)[1:]
    for width, out_rows in ((4, None), (8, 9), (16, 5)):
        got = grouping.gather_end_aligned(flat, ends, lens, width, out_rows)
        want = jax_grouping.gather_end_aligned(flat, ends, lens, width, out_rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    got = grouping.gather_end_aligned(flat, ends[:0], lens[:0], 4, 3)
    want = jax_grouping.gather_end_aligned(flat, ends[:0], lens[:0], 4, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch_size", [16, 13])
def test_bucket_plan_equals_jax(data, batch_size):
    hist_lens = data[1]
    got = scoring._bucket_plan(hist_lens, BUCKETS, batch_size)
    want = jax_scoring._bucket_plan(hist_lens, BUCKETS, batch_size, None)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _towers(kind):
    cfg = CFGS[kind]
    params = random_tower_params(np.random.default_rng(2), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(tower_state_dict_from_jax(kind, params), strict=True)
    return tower, jax_build_tower(_jax_cfg(cfg)), params


@pytest.mark.parametrize("kind", list(CFGS))
def test_bucketed_scores_match_jax(data, kind):
    """``user_vectors_bucketed`` and ``score_all_impressions(flat_tokens=
    False)`` within 1e-5 of the JAX package's, at batch 8 (several batches
    a bucket, pad rows in the last), rows past the largest bucket capped at
    their most recent clicks."""
    hist_rev, hist_lens, cand_rev, cand_row, emb = data
    tower, jtower, params = _towers(kind)
    apply = lambda p, e, m: jtower.apply(p, e, m)  # noqa: E731
    got = scoring.user_vectors_bucketed(tower, emb, hist_rev, hist_lens, batch_size=8, buckets=BUCKETS, device="cpu")
    want = jax_scoring.user_vectors_bucketed(apply, params, emb, hist_rev, hist_lens, batch_size=8, buckets=BUCKETS)
    assert got.dtype == np.float32 and got.shape == want.shape == (ROWS, D)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-5)
    got = scoring.score_all_impressions(
        tower, emb, hist_rev, hist_lens, cand_rev, cand_row, batch_size=8, buckets=BUCKETS, device="cpu"
    )
    want = jax_scoring.score_all_impressions(
        apply, params, emb, hist_rev, hist_lens, cand_rev, cand_row, batch_size=8, buckets=BUCKETS
    )
    assert got.shape == (300,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_latent_padded_equals_its_flat(data):
    """The latent tower's padded scores within 1e-5 of the port's flat
    scores, the flat eval capped at the largest bucket as the trainers cap
    it, so that both see the same truncated histories."""
    hist_rev, hist_lens, cand_rev, cand_row, emb = data
    tower = _towers("latent")[0]
    padded = scoring.score_all_impressions(
        tower, emb, hist_rev, hist_lens, cand_rev, cand_row, batch_size=8, buckets=BUCKETS, device="cpu"
    )
    flat = scoring.score_all_impressions(
        tower, emb, hist_rev, hist_lens, cand_rev, cand_row, flat_tokens=True, flat_max_len=BUCKETS[-1], device="cpu"
    )
    np.testing.assert_allclose(padded, flat, atol=1e-5)
    uncapped = scoring.score_all_impressions(tower, emb, hist_rev, hist_lens, cand_rev, cand_row, flat_tokens=True, device="cpu")
    assert np.abs(uncapped - padded).max() > 1e-3  # the cap matters on this data


def test_padded_scores_are_deterministic(data):
    hist_rev, hist_lens, cand_rev, cand_row, emb = data
    tower = _towers("transformer")[0]
    runs = [
        scoring.score_all_impressions(tower, emb, hist_rev, hist_lens, cand_rev, cand_row, batch_size=8, buckets=BUCKETS, device="cpu")
        for _ in range(2)
    ]
    np.testing.assert_array_equal(*runs)


def test_run_config0_matches_jax():
    """The frozen mean-pool scorer's metrics within 2e-5 of the JAX
    package's."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=80, num_rows=60, dim=16, noise=0.05, seed=4)
    c, jc = compile_behaviors(imps, hist), jax_compile(imps, hist)
    e = align_embeddings(c.news_ids, emb)
    got = run_config0(c, e, device="cpu")
    want = jax_configs.run_config0(jc, e)
    assert got["num_samples"] == want["num_samples"] == 60
    for k in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert got[k] == pytest.approx(want[k], abs=2e-5)


@pytest.mark.parametrize("kind", list(CFGS))
def test_padded_memory_estimators_equal_jax(kind):
    """``tower_activation_bytes`` and the two batch estimators equal the JAX
    package's at float32 (the port takes the element size from
    ``compute_dtype``, the JAX package 4 bytes always)."""
    for cfg in (TowerConfig(kind=kind), CFGS[kind]):
        jcfg = _jax_cfg(cfg)
        for b, l in ((1, 600), (512, 256), (64, 16)):
            assert memory.tower_activation_bytes(cfg, b, l) == jax_memory.tower_activation_bytes(jcfg, b, l)
        for length in (16, 600):
            budget = 80 * 2**30
            assert memory.estimate_tower_batch(cfg, length, budget) == jax_memory.estimate_tower_batch(jcfg, length, budget)
            assert memory.estimate_tower_train_batch(cfg, length, budget) == jax_memory.estimate_tower_train_batch(
                jcfg, length, budget
            )
    bf16 = dataclasses.replace(CFGS[kind], compute_dtype="bfloat16")
    assert 2 * memory.tower_activation_bytes(bf16, 8, 16) == memory.tower_activation_bytes(CFGS[kind], 8, 16)


def test_scoring_refuses_rows_beyond_the_histories(data):
    hist_rev, hist_lens, cand_rev, cand_row, emb = data
    with pytest.raises(ValueError, match="cand_row"):
        scoring.score_all_impressions(
            _towers("final_attention")[0], emb, hist_rev, hist_lens[:10], cand_rev, cand_row, device="cpu"
        )
