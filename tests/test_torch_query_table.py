"""The query table through the port's training and scoring, against the JAX
package: the user towers read the history tokens from e5's query-side
table and score the candidates against the passage table. Every check here
uses a query table that differs from the passage table, so a port that
read the histories from the passage table fails them. Also the dump's
realignment by news id (``load_embeddings(align_to_news_ids=)``).

The fixture: 160 train and 80 val rows of the learnable synthetic fixture
at d=32, the query table a noisy unit-norm copy of the passage table, two
epochs at lr 3e-4, batch 64, on the CPU; metrics and losses within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from news_recommendation_project_v2_tpu import configs as jax_configs
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.eval.ranker import history_candidate_slots as jax_slots
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.ops import encode as jax_encode
from news_recommendation_project_v2_tpu.ops import scoring as jax_scoring
from news_recommendation_project_v2_tpu.train import trainer as jax_trainer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.configs import run_config0
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
from news_recommendation_project_v2_torch.models import build_tower, convert, towers
from news_recommendation_project_v2_torch.ops import scoring
from news_recommendation_project_v2_torch.ops.encode import load_embeddings, save_embeddings
from news_recommendation_project_v2_torch.train.trainer import JointTowerTrainer, TowerTrainer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
TOWERS = {
    "latent": TowerConfig(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, latent_dim_head=16),
    "final_attention": TowerConfig(
        kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=64, dropout_rate=0.0
    ),
}
TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=64, seed=0)
BUCKETS = (32,)
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")
TOL = 1e-5


def _noisy(emb: np.ndarray, seed: int) -> np.ndarray:
    q = emb + 0.7 * np.random.default_rng(seed).standard_normal(emb.shape).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def fixture():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=120, num_rows=240, dim=D, noise=0.05, seed=3)
    query = _noisy(emb, 11)
    ct = compile_behaviors(imps[:160], hist[:160]).with_history_view()
    cv = compile_behaviors(imps[160:], hist[160:]).with_history_view()
    return dict(
        ct=ct, cv=cv,
        jct=jax_compile(imps[:160], hist[:160]).with_history_view(),
        jcv=jax_compile(imps[160:], hist[160:]).with_history_view(),
        emb_t=align_embeddings(ct.news_ids, emb), emb_v=align_embeddings(cv.news_ids, emb),
        q_t=align_embeddings(ct.news_ids, query), q_v=align_embeddings(cv.news_ids, query),
    )


def _jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _towers(kind: str):
    cfg = TOWERS[kind]
    params = convert.random_tower_params(np.random.default_rng(0), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.tower_state_dict_from_jax(kind, params))
    return tower, jax_build_tower(_jax_cfg(cfg)).apply, jax.tree.map(jnp.asarray, params)


def _assert_same(port, want, tol=TOL):
    assert [h["epoch"] for h in port] == [h["epoch"] for h in want]
    for got, ref in zip(port, want):
        assert got["loss"] == pytest.approx(ref["loss"], rel=tol)
        for split in ("train", "val"):
            for k in METRICS:
                assert got[split][k] == pytest.approx(ref[split][k], abs=tol), (got["epoch"], split, k)


ROUTES = {
    # tower kind, TowerTrainer flags, loss
    "flat_margin": ("latent", dict(flat_train=True, flat_eval=True, device_metrics=True), "margin"),
    "flat_infonce": ("latent", dict(flat_train=True, flat_eval=True, device_metrics=False), "infonce"),
    "padded_margin": ("final_attention", dict(flat_train=False, flat_eval=False), "margin"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_tower_trainer_reads_histories_from_the_query_table(fixture, route):
    """``TowerTrainer(query_news_emb_train=, query_news_emb_val=)`` epoch by
    epoch against the JAX package's; the same run without the query tables
    ends elsewhere."""
    f = fixture
    kind, flags, loss = ROUTES[route]
    cfg = dict(TRAIN, loss=loss)
    extra = {} if flags.get("flat_train") else {"buckets": BUCKETS}

    def port_run(**query):
        tower = _towers(kind)[0]
        return TowerTrainer(
            tower, f["ct"], f["emb_t"], compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=TrainConfig(**cfg),
            device="cpu", **query, **flags, **extra,
        ).train()

    port = port_run(query_news_emb_train=f["q_t"], query_news_emb_val=f["q_v"])
    _, apply, params = _towers(kind)
    want = jax_trainer.TowerTrainer(
        apply, params, f["jct"], jnp.asarray(f["emb_t"]), compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]),
        cfg=JaxTrainConfig(**cfg), query_news_emb_train=jnp.asarray(f["q_t"]),
        query_news_emb_val=jnp.asarray(f["q_v"]), **flags, **extra,
    ).train()
    _assert_same(port, want)
    passage_only = port_run()
    assert abs(passage_only[0]["loss"] - port[0]["loss"]) > 1e-3


def test_joint_trainer_reduces_the_query_table_at_eval(fixture):
    """``JointTowerTrainer`` with a blend and a reducer and both query
    tables: the histories read the reduced query table in training and at
    eval."""
    f = fixture
    rng = np.random.default_rng(5)
    blend_p, reduce_p = convert.random_weighted_sum_params(rng), convert.random_reducing_params(rng, D, D)
    blend, reduce = towers.WeightedSumModel(), towers.ReducingModel(D, D)
    blend.load_state_dict(convert.weighted_sum_state_dict_from_jax(blend_p))
    reduce.load_state_dict(convert.reducing_state_dict_from_jax(reduce_p))
    base_t = np.random.default_rng(6).standard_normal(f["ct"].num_news).astype(np.float32)
    base_v = np.random.default_rng(7).standard_normal(f["cv"].num_news).astype(np.float32)
    tower, apply, params = _towers("final_attention")
    port = JointTowerTrainer(
        tower, f["ct"], f["emb_t"], blend=blend, reduce=reduce, baseline_train=base_t, baseline_val=base_v,
        compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=TrainConfig(**TRAIN), buckets=BUCKETS, flat_eval=False,
        query_news_emb_train=f["q_t"], query_news_emb_val=f["q_v"], device="cpu",
    )
    jt = jax_trainer.JointTowerTrainer(
        apply, params, f["jct"], jnp.asarray(f["emb_t"]),
        blend_apply=jax_towers.WeightedSumModel().apply, blend_params=jax.tree.map(jnp.asarray, blend_p),
        reduce_apply=jax_towers.ReducingModel(D, D).apply, reduce_params=jax.tree.map(jnp.asarray, reduce_p),
        baseline_train=base_t, baseline_val=base_v, compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]),
        cfg=JaxTrainConfig(**TRAIN), buckets=BUCKETS,
        query_news_emb_train=jnp.asarray(f["q_t"]), query_news_emb_val=jnp.asarray(f["q_v"]),
    )
    _assert_same(port.train(), jt.train())


@pytest.mark.parametrize("route", ["bucketed", "flat"])
def test_score_all_impressions_reads_the_query_table(fixture, route):
    f = fixture
    c = f["cv"]
    slots, rows = history_candidate_slots(c)
    args = (c.hist_rev, c.hist_lens, c.imp_rev[slots], rows)
    kind = "latent"
    tower, apply, params = _towers(kind)
    kwargs = dict(flat_tokens=True, flat_max_len=BUCKETS[-1]) if route == "flat" else dict(buckets=BUCKETS, batch_size=16)
    got = scoring.score_all_impressions(tower, f["emb_v"], *args, query_news_emb=f["q_v"], device="cpu", **kwargs)
    want = jax_scoring.score_all_impressions(
        apply, params, jnp.asarray(f["emb_v"]), *args, query_news_emb=jnp.asarray(f["q_v"]), **kwargs
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    passage_only = scoring.score_all_impressions(tower, f["emb_v"], *args, device="cpu", **kwargs)
    assert np.abs(passage_only - got).max() > 1e-2


def test_run_config0_reads_the_query_table(fixture):
    f = fixture
    got = run_config0(f["cv"], f["emb_v"], query_news_embeddings=f["q_v"], device="cpu")
    want = jax_configs.run_config0(f["jcv"], f["emb_v"], query_news_embeddings=f["q_v"])
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], abs=TOL)
    assert got != run_config0(f["cv"], f["emb_v"], device="cpu")
    np.testing.assert_array_equal(jax_slots(f["jcv"])[0], history_candidate_slots(f["cv"])[0])


def test_load_embeddings_realigns_a_shuffled_dump(tmp_path):
    """A dump written in one row order loads in another by its id key,
    both tables, as the JAX package loads it."""
    rng = np.random.default_rng(0)
    ids = np.array([f"N{i}" for i in range(20)])
    emb, query = rng.standard_normal((20, 4), dtype=np.float32), rng.standard_normal((20, 4), dtype=np.float32)
    perm = rng.permutation(20)
    save_embeddings(tmp_path, "dev", emb[perm], query[perm], news_ids=ids[perm])
    want_order = ids[rng.permutation(20)[:12]]
    got_e, got_q = load_embeddings(tmp_path, "dev", with_query=True, align_to_news_ids=want_order)
    rows = [int(n[1:]) for n in want_order]
    np.testing.assert_array_equal(got_e, emb[rows])
    np.testing.assert_array_equal(got_q, query[rows])
    np.testing.assert_array_equal(load_embeddings(tmp_path, "dev", align_to_news_ids=want_order), emb[rows])
    j_e, j_q = jax_encode.load_embeddings(tmp_path, "dev", with_query=True, align_to_news_ids=want_order)
    np.testing.assert_array_equal(got_e, j_e)
    np.testing.assert_array_equal(got_q, j_q)


def test_load_embeddings_realign_errors_match_jax(tmp_path):
    emb = np.zeros((3, 2), np.float32)
    save_embeddings(tmp_path / "positional", "dev", emb)
    save_embeddings(tmp_path / "keyed", "dev", emb, news_ids=np.array(["N0", "N1", "N2"]))
    for root, ids, error in (
        (tmp_path / "positional", ["N0"], FileNotFoundError),
        (tmp_path / "keyed", ["N0", "N7"], KeyError),
    ):
        with pytest.raises(error) as got:
            load_embeddings(root, "dev", align_to_news_ids=ids)
        with pytest.raises(error) as want:
            jax_encode.load_embeddings(root, "dev", align_to_news_ids=ids)
        assert str(got.value) == str(want.value)
