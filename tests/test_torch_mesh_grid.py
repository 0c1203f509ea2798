"""The port's row-sharded table, data-parallel steps and trainers on
meshes of CPU ranks (gloo), against the port's single-rank runs and the
JAX package's mesh runs.

Each mesh shape, (2, 1) and (2, 2), is one spawn of its ranks
(``parallel.mesh.launch``, rank code in ``torch_mesh_workers``, which loads
no JAX). Every rank checks its shard of a 41-row table and the sharded
gather (bit-equal to the plain one), runs three data-parallel steps of each
loss (flat and padded margin and InfoNCE, joint, classification margin and
InfoNCE; the last batch of the epoch, with pad pairs, among them) against
the single-rank step at the same parameters (loss 1e-6, gradients a
norm-relative 1e-5), and then runs ``TowerTrainer(mesh=)`` by the flat and
the padded step (two epochs of the JAX package's learnable d = 32 fixture,
``tests/test_sharding.py::_learnable_trainer``), ``JointTowerTrainer(mesh=)``
and ``ClassificationTrainer(mesh=)`` (one epoch each, the fixtures of
``test_mesh_joint_trainer_matches_single_device`` and
``test_mesh_classification_trainer_matches_single_device``). The weights
are the JAX tests' (``init`` with key 0), handed to the ranks as numpy.

Held: each rank's history against the port's single-rank run (metrics abs
1e-6, loss rel 1e-4, as the JAX package holds its own mesh runs) and
against the JAX package's run on its virtual 8-device mesh (data 4, model
2) within 1e-5; the parameters equal to the bit on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from news_recommendation_project_v2_torch.config import MeshConfig
from news_recommendation_project_v2_torch.parallel import build_mesh, launch
from news_recommendation_project_v2_torch.parallel.mesh import default_backend
from news_recommendation_project_v2_tpu.config import MeshConfig as JaxMeshConfig
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.data.synthetic import align_embeddings as jax_align
from news_recommendation_project_v2_tpu.data.synthetic import synthetic_learnable_behaviors as jax_learnable
from news_recommendation_project_v2_tpu.models import ClassificationHead as JaxHead
from news_recommendation_project_v2_tpu.models import WeightedSumModel as JaxBlend
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.parallel import build_mesh as jax_build_mesh
from news_recommendation_project_v2_tpu.train import trainer as jax_trainer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = workers.D
TRAINERS = ("tower_flat", "tower_padded", "joint", "classification")


def _jax_params() -> dict:
    tower = jax_build_tower(JaxTowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8))
    tp = jax.jit(lambda: tower.init(jax.random.key(0), jnp.zeros((1, 8, D)), jnp.ones((1, 8))))()
    head = JaxHead(in_dim=D, hidden_dim=D)
    hp = jax.jit(lambda: head.init(jax.random.key(0), jnp.zeros((1, D))))()
    return dict(tower=jax.tree.map(np.asarray, tp), head=jax.tree.map(np.asarray, hp))


def _jax_data(num_news, num_rows, history_view=True):
    imps, hist, emb = jax_learnable(num_news=num_news, num_rows=num_rows, dim=D, noise=0.05)
    c = jax_compile(imps, hist)
    c = c.with_history_view() if history_view else c
    return c, jnp.asarray(jax_align(c.news_ids, emb))


def _jax_runs(params) -> dict:
    """The JAX package's mesh runs of the same four trainers."""
    mesh = jax_build_mesh(JaxMeshConfig(data_size=4, model_size=2))
    tower = jax_build_tower(JaxTowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8))

    def tp():  # fresh arrays per trainer: the JAX steps donate their parameters
        return jax.tree.map(jnp.asarray, params["tower"])

    out = {}
    c, emb = _jax_data(120, 150)
    for name, flat in (("tower_flat", True), ("tower_padded", False)):
        out[name] = jax_trainer.TowerTrainer(
            tower.apply, tp(), c, emb, compiled_val=c, news_emb_val=emb,
            cfg=JaxTrainConfig(learning_rate=3e-4, num_epochs=2, batch_size=64, seed=0), mesh=mesh, flat_train=flat,
        ).train()
    c, emb = _jax_data(100, 120)
    base = workers.baseline_scores(c.num_news)
    blend = JaxBlend()
    bp = jax.jit(lambda: blend.init(jax.random.key(1), jnp.zeros(2), jnp.zeros(2)))()
    out["joint"] = jax_trainer.JointTowerTrainer(
        tower.apply, tp(), c, emb, blend_apply=blend.apply, blend_params=bp, baseline_train=base, baseline_val=base,
        compiled_val=c, news_emb_val=emb, cfg=JaxTrainConfig(learning_rate=3e-4, num_epochs=1, batch_size=40, seed=0),
        mesh=mesh,
    ).train()
    c, emb = _jax_data(90, 110, history_view=False)
    out["classification"] = jax_trainer.ClassificationTrainer(
        JaxHead(in_dim=D, hidden_dim=D).apply, jax.tree.map(jnp.asarray, params["head"]), c, emb, compiled_val=c,
        news_emb_val=emb, cfg=JaxTrainConfig(learning_rate=1e-3, num_epochs=1, batch_size=64, seed=0), mesh=mesh,
    ).train()
    return out


@pytest.fixture(scope="module")
def runs():
    params = _jax_params()
    meshes = {
        shape: launch(workers.grid_worker, shape[0] * shape[1], args=(*shape, params, True), backend="gloo", timeout=600)
        for shape in ((2, 1), (2, 2))
    }
    return dict(meshes=meshes, single=workers.single_trainer_runs(params), jax=_jax_runs(params))


def _compare(got, want, metric_abs, loss_rel):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=loss_rel), g["epoch"]
        for split in ("train", "val"):
            assert g[split]["num_samples"] == w[split]["num_samples"]
            for k in ("auc", "mrr", "ndcg5", "ndcg10"):
                assert g[split][k] == pytest.approx(w[split][k], abs=metric_abs), (g["epoch"], split, k)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["mesh2x1", "mesh2x2"])
@pytest.mark.parametrize("name", TRAINERS)
def test_mesh_trainer_matches_single_rank(runs, shape, name):
    single_history, _ = runs["single"][name]
    for rank in runs["meshes"][shape]:
        _compare(rank["trainers"][name][0], single_history, metric_abs=1e-6, loss_rel=1e-4)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["mesh2x1", "mesh2x2"])
@pytest.mark.parametrize("name", TRAINERS)
def test_mesh_trainer_matches_jax_mesh(runs, shape, name):
    _compare(runs["meshes"][shape][0]["trainers"][name][0], runs["jax"][name], metric_abs=1e-5, loss_rel=1e-5)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["mesh2x1", "mesh2x2"])
def test_mesh_trainer_ranks_hold_equal_parameters(runs, shape):
    ranks = runs["meshes"][shape]
    for name in TRAINERS:
        first = ranks[0]["trainers"][name][1]
        for rank in ranks[1:]:
            for k, v in rank["trainers"][name][1].items():
                assert np.array_equal(v, first[k]), (name, rank["rank"], k)


def test_mesh_tower_trainer_learns(runs):
    history, _ = runs["meshes"][(2, 2)][0]["trainers"]["tower_flat"]
    assert history[-1]["val"]["auc"] > 0.55


SHAPES = [(2, 1), (2, 2)]
IDS = ["mesh2x1", "mesh2x2"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_table_layout_and_gather(runs, shape):
    data, model = shape
    for rank in runs["meshes"][shape]:
        t = rank["table"]
        assert t["shape"] == (-(-41 // model) * model, 8)  # padded to a multiple of the model axis
        assert t["shard_equal"] and t["gather_equal"] and t["full_equal"], rank["coords"]
        d = rank["coords"][0]
        assert t["batch_slice"] == (d * 8 // data, (d + 1) * 8 // data)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("kind", workers.STEP_KINDS)
def test_sharded_step_matches_single_rank(runs, shape, kind):
    ranks = runs["meshes"][shape]
    for rank in ranks:
        got = rank["steps"][kind]
        assert got["steps"] == 3
        assert got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-5, (rank["rank"], got["loss_err"], got["grad_err"])
        for k, v in got["params"].items():
            assert np.array_equal(v, ranks[0]["steps"][kind]["params"][k]), (rank["rank"], k)


@pytest.mark.parametrize(
    "device,want", [("cpu", "gloo"), ("cuda", "nccl"), (None, "nccl")], ids=["cpu", "cuda", "default"]
)
def test_backend_follows_the_device(device, want):
    assert default_backend(device) == want


def test_build_mesh_refuses_a_backend_the_group_does_not_run(tmp_path):
    """A joined group keeps its backend: naming another raises instead of
    swapping it, and a gloo world of one carries the CPU's tensors."""
    assert build_mesh(MeshConfig(), device="cpu").shape == {"data": 1, "model": 1}  # no group: a world of one
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert build_mesh(MeshConfig(), device="cpu").size == 1
        with pytest.raises(ValueError, match="not the nccl asked for"):
            build_mesh(MeshConfig(), backend="nccl", device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(TypeError):
        launch(workers.grid_worker, 2)  # the backend is the caller's to name
