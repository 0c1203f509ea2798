"""The port's copies of the JAX package's training-data host code
(``data.sampling``, ``data.synthetic``, ``data.prefetch``) and the trainer's
flat batches: from the same ``np.random.Generator`` state both packages draw
the same numbers and build equal arrays, element for element and type for
type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data import prefetch as jax_prefetch
from news_recommendation_project_v2_tpu.data import sampling as jax_sampling
from news_recommendation_project_v2_tpu.data import synthetic as jax_synthetic
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.train.trainer import TowerTrainer as JaxTowerTrainer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data import prefetch, sampling, synthetic
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

SMALL = dict(reduced_dim=32, embedding_dim=32, num_latents=4, num_heads=2, latent_dim_head=8)


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def impressions():
    """Impressions of 1 to 25 candidates, some with a single positive or a
    single negative, some with fewer negatives than an InfoNCE K of 5."""
    rng = np.random.default_rng(4)
    imp_lens = rng.integers(2, 26, 120)
    imp_lens[:5] = (2, 3, 4, 5, 6)
    labels = (rng.random(int(imp_lens.sum())) < 0.3).astype(np.int8)
    ends = np.cumsum(imp_lens)
    labels[ends - imp_lens], labels[ends - 1] = 1, 0
    imp_rev = rng.integers(0, 500, int(imp_lens.sum())).astype(np.int32)
    return imp_rev, imp_lens.astype(np.int32), labels


RATIOS = {"none": (None, None), "neg_cap": (0.5, None), "pos_cap": (None, 0.5), "both": (0.5, 2.0)}


@pytest.mark.parametrize("ratios", list(RATIOS))
@pytest.mark.parametrize("name", ["sample_pos_neg_pairs", "sample_pos_neg_pairs_loop"])
def test_pair_samplers_match_jax(impressions, name, ratios):
    got = getattr(sampling, name)(np.random.default_rng(1), *impressions, *RATIOS[ratios])
    want = getattr(jax_sampling, name)(np.random.default_rng(1), *impressions, *RATIOS[ratios])
    _equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("name", ["sample_pos_neg_infonce", "sample_pos_neg_infonce_loop"])
def test_infonce_samplers_match_jax(impressions, name, k):
    """K past some impressions' negatives gives -1 pads (every impression
    has one negative, so K = 1 gives none); K = 12 runs the rejection
    sampler's straggler path."""
    got = getattr(sampling, name)(np.random.default_rng(2), *impressions, k)
    want = getattr(jax_sampling, name)(np.random.default_rng(2), *impressions, k)
    _equal(got, want)
    assert (got[1:-1] == -1).any() == (k > 1)


@pytest.mark.parametrize("batch_size", [None, 16, 1000])
@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_epoch_pairs_match_jax(impressions, loss, batch_size):
    kwargs = dict(loss=loss, num_neg_per_pos=5, batch_size=batch_size)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    got = sampling.sample_epoch_pairs(rng, *impressions, **kwargs)
    want = jax_sampling.sample_epoch_pairs(jrng, *impressions, **kwargs)
    _equal(got, want)
    assert rng.bit_generator.state == jrng.bit_generator.state
    pairs, negs = got
    for start, stop, pad in ((0, 16, 0), (pairs.shape[1] - 5, pairs.shape[1], 11)):
        _equal(
            sampling.neg_batch_column(pairs, negs, start, stop, pad),
            jax_sampling.neg_batch_column(pairs, negs, start, stop, pad),
        )


@pytest.mark.parametrize("total, batch_size", [(0, 4), (3, 4), (4, 4), (37, 8), (64, 8)])
def test_batch_aligned_permutation_matches_jax(total, batch_size):
    _equal(
        sampling.batch_aligned_permutation(np.random.default_rng(5), total, batch_size),
        jax_sampling.batch_aligned_permutation(np.random.default_rng(5), total, batch_size),
    )


def test_equalize_side_refuses_an_empty_side():
    with pytest.raises(ValueError, match="empty label side"):
        sampling._equalize_side(np.random.default_rng(0), np.arange(2), np.array([2, 0]), np.array([2, 1]))


def test_synthetic_fixture_matches_jax():
    got = synthetic.synthetic_learnable_behaviors(num_news=50, num_rows=30, dim=16, noise=0.05, seed=7)
    want = jax_synthetic.synthetic_learnable_behaviors(num_news=50, num_rows=30, dim=16, noise=0.05, seed=7)
    assert got[0] == want[0] and got[1] == want[1]
    _equal(got[2], want[2])
    _equal(synthetic.synthetic_news_embeddings(20, 8, seed=3), jax_synthetic.synthetic_news_embeddings(20, 8, seed=3))
    ids = compile_behaviors(got[0], got[1]).news_ids
    _equal(synthetic.align_embeddings(ids, got[2]), jax_synthetic.align_embeddings(ids, got[2]))


def test_prefetch_keeps_order_and_raises_at_the_consumer():
    assert list(prefetch.prefetch(iter(range(50)), depth=2)) == list(range(50))

    def broken():
        yield 1
        raise KeyError("producer")

    it = prefetch.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)
    assert list(prefetch.prefetch(iter(()))) == list(jax_prefetch.prefetch(iter(())))


@pytest.fixture(scope="module")
def behaviors():
    """The learnable fixture's strings, compiled by both packages (equal
    arrays, held by tests/test_torch_flat_eval.py's compiler test), with
    histories past the 16-click cap used below."""
    imps, hist, emb = synthetic.synthetic_learnable_behaviors(
        num_news=80, num_rows=90, dim=32, max_history=30, noise=0.05, seed=5
    )
    return compile_behaviors(imps, hist).with_history_view(), jax_compile(imps, hist).with_history_view(), emb


@pytest.mark.parametrize("batch_size", [16, 64])
@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_epoch_batches_flat_match_jax(behaviors, loss, batch_size):
    """Two epochs of ``_epoch_batches_flat`` from the same seed: every batch
    array equal to the JAX trainer's, with histories capped at the last
    bucket (16 here) and token streams padded to powers of two."""
    ct, jct, emb = behaviors
    buckets = (8, 16)
    cfg = dict(batch_size=batch_size, loss=loss, num_neg_per_pos=5, seed=11)
    trainer = TowerTrainer(
        build_tower(TowerConfig(**SMALL)), ct, emb, cfg=TrainConfig(**cfg), buckets=buckets,
        device="cpu",
    )
    jtower = jax_build_tower(JaxTowerConfig(kind="latent", **SMALL))
    params = jtower.init(jax.random.key(0), jnp.zeros((1, 4, 32)), jnp.ones((1, 4)))
    jtrainer = JaxTowerTrainer(
        jtower.apply, params, jct, jnp.asarray(emb), cfg=JaxTrainConfig(**cfg), buckets=buckets, flat_train=True
    )
    for _ in range(2):
        got, want = list(trainer._epoch_batches_flat()), list(jtrainer._epoch_batches_flat())
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _equal(g, w)
    assert max(int(b[2].max()) for b in got) == 16
    assert {b[0].shape[0] for b in got} >= {1024}
    pinned = next(trainer._host_batches())
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in pinned)
