"""The port's sharded flat eval and ``configs.run_config3`` on a (1, 2) mesh
of CPU ranks (gloo), against the port's single-device eval and the JAX
package's sharded eval and ``run_config3``.

One spawn of two ranks (``parallel.mesh.launch``; rank code in
``torch_mesh_workers``, which loads no JAX) runs every check: the table's
row shards and the data-parallel steps as in ``test_torch_mesh_grid.py``;
``ShardedFlatEvalPlan.score`` on candidate slots in arbitrary order against
the JAX package's ``ShardedFlatEvalPlan`` on its virtual 8-device mesh
(``tests/test_sharding.py::test_sharded_flat_eval_unsorted_slots``, 2e-5 as
there); on the learnable fixture, the sharded scores and the fused metrics
of ``ShardedMetricsPlan`` (a content baseline blended at alpha 0.7) against
the port's ``FlatEvalPlan`` and ``DeviceMetricsPlan`` (scores 1e-6, metrics
1e-6); ``score_all_impressions(mesh=)`` by both routes against the
single-device calls (1e-6); and ``run_config3`` (two epochs of the d = 32
fixture) against the JAX package's ``run_config3`` on a (4, 2) mesh from the
same weights (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from news_recommendation_project_v2_torch.config import MeshConfig, TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
from news_recommendation_project_v2_torch.models.convert import random_tower_params
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan, score_all_impressions
from news_recommendation_project_v2_torch.parallel import launch
from news_recommendation_project_v2_tpu import configs as jax_configs
from news_recommendation_project_v2_tpu.config import MeshConfig as JaxMeshConfig
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.parallel import build_mesh as jax_build_mesh
from news_recommendation_project_v2_tpu.parallel.flat_eval import ShardedFlatEvalPlan as JaxShardedFlatEvalPlan
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = workers.D
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")
TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=64, seed=0)
TOWER = dict(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8)


def _unsorted_case() -> dict:
    rng = np.random.default_rng(1234)
    R, C, N = 40, 200, 40
    hist_lens = rng.integers(1, 12, size=R)
    return dict(
        hist_lens=hist_lens,
        hist_rev=rng.integers(0, N, size=int(hist_lens.sum())).astype(np.int32),
        cand_rev=rng.integers(0, N, size=C).astype(np.int32),
        cand_row=rng.integers(0, R, size=C).astype(np.int32),  # not sorted
        table=rng.standard_normal((N, D)).astype(np.float32),
    )


def _config3_data():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=120, num_rows=140, dim=D, noise=0.05)
    c = compile_behaviors(imps, hist)
    return imps, hist, emb, c, align_embeddings(c.news_ids, emb)


class _FixedInit:
    """A flax module whose ``init`` returns given parameters: the JAX
    ``run_config3`` then starts from the port's numpy-drawn weights."""

    def __init__(self, module, params):
        self.apply = module.apply
        self._params = params

    def init(self, *args, **kwargs):
        return jax.tree.map(jnp.asarray, self._params)


@pytest.fixture(scope="module")
def runs():
    params = workers.numpy_params()
    _, _, _, c, emb = _config3_data()
    config3 = dict(
        compiled=c, news_embeddings=emb, compiled_val=c, news_embeddings_val=emb,
        mesh_cfg=MeshConfig(model_size=2), train_cfg=TrainConfig(**TRAIN), tower_cfg=TowerConfig(**TOWER),
    )
    ranks = launch(workers.eval_worker, 2, args=(params, _unsorted_case(), config3), backend="gloo", timeout=600)
    return dict(ranks=ranks, params=params)


def test_sharded_table_and_steps_on_a_model_axis(runs):
    for rank in runs["ranks"]:
        t = rank["table"]
        assert t["shape"] == (42, 8) and t["shard_equal"] and t["gather_equal"] and t["full_equal"]
        for kind, got in rank["steps"].items():
            assert got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-5, kind
            for k, v in got["params"].items():
                assert np.array_equal(v, runs["ranks"][0]["steps"][kind]["params"][k]), (kind, k)


def test_sharded_flat_eval_unsorted_slots_matches_jax(runs):
    u = _unsorted_case()
    mesh = jax_build_mesh(JaxMeshConfig(data_size=4, model_size=2))
    jtower = jax_build_tower(JaxTowerConfig(**TOWER))
    want = JaxShardedFlatEvalPlan(
        mesh, u["hist_rev"], u["hist_lens"], u["cand_rev"], u["cand_row"], chunk_tokens=32, cand_chunk=16
    ).score(jtower.apply, jax.tree.map(jnp.asarray, runs["params"]["tower"]), jnp.asarray(u["table"]))
    shares = [rank["unsorted_share"] for rank in runs["ranks"]]
    assert sum(shares) == pytest.approx(1.0) and min(shares) > 0.3
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["unsorted_scores"], np.asarray(want), atol=2e-5)


def _single_eval(params):
    c, emb = workers.learnable(num_news=100, num_rows=90)
    slots, cand_rows = history_candidate_slots(c)
    tower = workers.tower_from(params).eval()
    fplan = FlatEvalPlan(c.hist_rev, c.hist_lens, c.imp_rev[slots], cand_rows, chunk_tokens=64, cand_chunk=32,
                         device="cpu")
    base = workers.baseline_scores(c.num_news)[c.imp_rev]
    mplan = DeviceMetricsPlan(c.imp_lens, c.labels_flat, hist_slots=slots, baseline_slots=base, alpha=0.7, device="cpu")
    args = (tower, emb, c.hist_rev, c.hist_lens, c.imp_rev[slots], cand_rows)
    return dict(
        num_impressions=c.num_rows, scores=fplan.score(tower, emb), metrics=fplan.metrics(tower, emb, mplan),
        scores_flat=score_all_impressions(*args, flat_tokens=True, flat_max_len=600, device="cpu"),
        scores_bucketed=score_all_impressions(*args, device="cpu"),
    )


def test_sharded_flat_eval_and_metrics_match_single_device(runs):
    want = _single_eval(runs["params"])
    assert sum(rank["impressions"] for rank in runs["ranks"]) == want["num_impressions"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["scores"], want["scores"], atol=1e-6)
        assert rank["metrics"]["num_samples"] == want["metrics"]["num_samples"]
        for k in METRICS:
            assert rank["metrics"][k] == pytest.approx(want["metrics"][k], abs=1e-6), k


@pytest.mark.parametrize("route", ["flat", "bucketed"])
def test_score_all_impressions_on_a_mesh(runs, route):
    want = _single_eval(runs["params"])[f"scores_{route}"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[f"scores_{route}"], want, atol=1e-6)


def test_run_config3_matches_jax(runs, monkeypatch):
    _, _, _, c, emb = _config3_data()
    # The JAX package's own compile of the same strings, so its run is its own.
    imps, hist, _, _, _ = _config3_data()
    jc = jax_compile(imps, hist)
    assert jc.news_ids.tolist() == c.news_ids.tolist()
    params = random_tower_params(np.random.default_rng(TRAIN["seed"]), TowerConfig(**TOWER))
    monkeypatch.setattr(jax_configs, "build_tower", lambda cfg: _FixedInit(jax_build_tower(cfg), params))
    want = jax_configs.run_config3(
        jc, emb, compiled_val=jc, news_embeddings_val=emb, mesh_cfg=JaxMeshConfig(data_size=4, model_size=2),
        train_cfg=JaxTrainConfig(**TRAIN), tower_cfg=JaxTowerConfig(**TOWER),
    )
    for rank in runs["ranks"]:
        got = rank["config3"]
        assert got["num_samples"] == want["num_samples"]
        for k in METRICS:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k
    assert runs["ranks"][0]["config3"]["auc"] > 0.55
