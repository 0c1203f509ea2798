"""The port's end-to-end path on meshes of CPU ranks (gloo): the row-sharded
token store, the data-parallel e2e steps, ``EndToEndTrainer(mesh=)`` and
``materialize_from_token_store_mesh``, against the port's single-rank runs
and the JAX package's single-device functions.

Two spawns (``parallel.mesh.launch``; rank code in ``torch_mesh_workers``,
which loads no JAX): a world of two ranks runs meshes (2, 1) and (1, 2), a
world of four mesh (2, 2), which also runs the forward functions and mesh
serving once (``tests/test_torch_mesh_encode.py`` and
``test_torch_mesh_serve.py`` hold them on the other shapes). On each mesh,
for the four routes of the JAX package's
``tests/test_sharding.py::test_mesh_e2e_trainer_matches_single_device``
(streamed, the store replicated on every rank, the store row-sharded over
every rank, the sharded store with InfoNCE), at its shapes (80 news and 80
rows at d = 32, batch 32, 8 tokens, one epoch at lr 1e-4, 3 negatives):

- three data-parallel steps (the epoch's first two batches and its last,
  with pad pairs) against one rank's loss (1e-6) and gradient (a
  norm-relative 1e-5) of the global batch at the same weights;
- the trainer's epoch, step by step, against the JAX package's
  single-device ``EndToEndTrainer`` on the same data and weights (loss
  1e-6 a step), and the ranks' weights equal to the bit;
- ``materialize_from_token_store_mesh`` from the replicated and the sharded
  store over 37 news (batch 16) against the JAX package's
  ``materialize_from_token_store`` (1e-5, as its mesh test holds its own);
- the sharded store's shard and its gather against the plain gather (to
  the bit).

On mesh (2, 2) the world of four also runs the forward functions and mesh
serving, held by ``test_torch_mesh_encode.check_forward`` and
``test_torch_mesh_serve.check_serving``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from test_torch_mesh_encode import FORWARD_PARTS, check_forward
from test_torch_mesh_serve import CALLS, check_serving
from news_recommendation_project_v2_torch.config import MeshConfig, TrainConfig
from news_recommendation_project_v2_torch.parallel import launch
from news_recommendation_project_v2_torch.parallel.mesh import Mesh
from news_recommendation_project_v2_torch.train import trainer as trainer_module
from news_recommendation_project_v2_torch.utils import memory
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops.encode import TokenStore as JaxTokenStore
from news_recommendation_project_v2_tpu.ops.encode import materialize_from_token_store as jax_materialize
from news_recommendation_project_v2_tpu.train.trainer import EndToEndTrainer as JaxEndToEndTrainer
from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = workers.D
SHAPES = [(2, 1), (1, 2), (2, 2)]
IDS = ["mesh2x1", "mesh1x2", "mesh2x2"]
ROUTES = list(workers.E2E_ROUTES)


def _jax_run(route: str) -> list[float]:
    """The JAX package's single-device trainer on the route's store, dropout
    off: every step's loss."""
    device_store, _, loss = workers.E2E_ROUTES[route]
    imps, hist, arrays, _, _ = workers.e2e_fixture()
    params = workers.e2e_params()
    enc = JaxTokenAttentionPool(hidden_size=D, num_layers=1)

    def enc_apply(p, s, m, deterministic=False, rngs=None):
        return enc.apply(p, s, m, deterministic=True)

    tower = jax_build_tower(JaxTowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8))
    jt = JaxEndToEndTrainer(
        enc_apply, jax.tree.map(jnp.asarray, params["token_encoder"]), tower.apply,
        jax.tree.map(jnp.asarray, params["tower"]), jax_compile(imps, hist).with_history_view(),
        JaxTokenStore.from_ragged(arrays), cfg=JaxTrainConfig(loss=loss, **workers.E2E_TRAIN),
        max_token_len=workers.E2E_MAX_LEN, device_store=device_store,
    )
    jt.TOKEN_BUCKETS = workers.E2E_TOKEN_BUCKETS
    losses, step = [], jt._train_step

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[2]))
        return out

    jt._train_step = recorded
    jt.train()
    return losses


@pytest.fixture(scope="module")
def runs():
    params = workers.e2e_params()
    two = launch(workers.e2e_worker, 2, args=([(2, 1), (1, 2)], params), backend="gloo", timeout=600)
    four = launch(workers.e2e_worker, 4, args=([(2, 2)], params), backend="gloo", timeout=600)
    meshes = {shape: [r[shape] for r in two] for shape in ((2, 1), (1, 2))}
    meshes[(2, 2)] = [r[(2, 2)] for r in four]
    # One device has no sharded store: its "sharded" run is the replicated one.
    single = {r: workers.e2e_run(None, r, params) for r in ROUTES if r != "sharded"}
    jax_runs = {r: _jax_run(r) for r in ROUTES if r != "sharded"}
    single["sharded"], jax_runs["sharded"] = single["replicated"], jax_runs["replicated"]
    return dict(meshes=meshes, single=single, jax=jax_runs)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("route", ROUTES)
def test_e2e_steps_match_single_rank(runs, shape, route):
    ranks = runs["meshes"][shape]
    for rank in ranks:
        got = rank["steps"][route]
        assert got["steps"] == 3
        assert got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-5, (got["loss_err"], got["grad_err"])
        for k, v in got["params"].items():
            assert np.array_equal(v, ranks[0]["steps"][route]["params"][k]), k


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("route", ROUTES)
def test_e2e_trainer_matches_jax_step_by_step(runs, shape, route):
    want = runs["jax"][route]
    single = runs["single"][route]
    assert len(single["losses"]) == len(want) > 3
    np.testing.assert_allclose(single["losses"], want, rtol=0, atol=1e-6)
    ranks = runs["meshes"][shape]
    device_store, shard_store, _ = workers.E2E_ROUTES[route]
    total = int(workers.e2e_fixture()[4].offsets[-1])
    world = shape[0] * shape[1]
    for rank in ranks:
        run = rank["runs"][route]
        assert (run["device_store"], run["store_sharded"]) == (device_store, shard_store)
        if shard_store:
            padded = -(-total // world) * world  # rows pad to a multiple of the world
            assert (run["store_rows"], run["shard_rows"]) == (padded, padded // world)
        np.testing.assert_allclose(run["losses"], want, rtol=0, atol=1e-6)
        assert run["history"][-1]["loss"] == pytest.approx(single["history"][-1]["loss"], rel=1e-6)
        for k, v in run["params"].items():
            assert np.array_equal(v, ranks[0]["runs"][route]["params"][k]), k


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("store", ["replicated", "sharded"])
def test_materialize_on_a_mesh_matches_jax(runs, shape, store):
    arrays, _, params = workers.materialize_fixture()
    enc = JaxTokenAttentionPool(hidden_size=D, num_layers=1)
    want = jax_materialize(
        lambda p, s, m: enc.apply(p, s, m, deterministic=True), jax.tree.map(jnp.asarray, params),
        JaxTokenStore.from_ragged(arrays), batch_size=16, max_token_len=8, token_buckets=(8,),
    )
    for rank in runs["meshes"][shape]:
        got = rank["materialize"][store]
        assert got.shape == (37, D)
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_store_layout_and_gather(runs, shape):
    total = sum(len(a) for a in workers.materialize_fixture()[0])
    world = shape[0] * shape[1]
    for rank in runs["meshes"][shape]:
        s = rank["materialize"]["store"]
        assert s["shape"] == (-(-total // world) * world, D) and s["rows_per_shard"] == -(-total // world)
        assert s["shard_equal"] and s["gather_equal"]


@pytest.mark.parametrize("part", FORWARD_PARTS)
def test_forward_functions_on_mesh_2x2(runs, part):
    check_forward(part, [r["forward"] for r in runs["meshes"][(2, 2)]], model=2)


@pytest.fixture(scope="module")
def serving():
    """The single-device port ranker's and the JAX package's answers."""
    from news_recommendation_project_v2_tpu.serve import Ranker as JaxRanker
    from test_torch_mesh_serve import _jax_tower

    table, ids = workers.serve_table()
    jax_ranker = JaxRanker(_jax_tower().apply, jax.tree.map(jnp.asarray, workers.numpy_params()["tower"]), table, ids)
    return workers.serve_calls(workers.serve_ranker(None)), workers.serve_calls(jax_ranker)


@pytest.mark.parametrize("call", CALLS)
def test_mesh_ranker_on_mesh_2x2(runs, serving, call):
    check_serving(call, runs["meshes"][(2, 2)], *serving)


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("budget", [2**20, 2**26])
def test_fits_device_token_store_by_shards_matches_jax(num_shards, budget):
    for tokens, dim, es in ((100_001, 64, 4), (1_469_565, 1024, 2), (7, 16, 4)):
        assert memory.fits_device_token_store(tokens, dim, es, budget, num_shards=num_shards) == (
            jax_memory.fits_device_token_store(tokens, dim, es, budget, num_shards=num_shards)
        )


def _trainer(mesh, **kwargs):
    _, _, _, c, store = workers.e2e_fixture()
    model = workers.e2e_modules(workers.e2e_params())
    return trainer_module.EndToEndTrainer(
        model["token_encoder"], model["tower"], c, store, cfg=TrainConfig(**workers.E2E_TRAIN), max_token_len=8,
        mesh=mesh, device="cpu", **kwargs,
    )


def test_e2e_trainer_store_rules(monkeypatch):
    """The JAX package's rules: a store that fits one card only once sharded
    over the mesh stays resident and shards by default; ``shard_store``
    wants a mesh and the resident store; the batch divides over the data
    axis. A mesh object of two model ranks without a process group: the
    constructor runs no collective."""
    mesh = Mesh(MeshConfig(), 1, 2, 0)
    monkeypatch.setattr(trainer_module, "fits_device_token_store", lambda *a, num_shards=1, **k: num_shards > 1)
    t = _trainer(mesh)
    total = int(t.store.offsets[-1])
    assert t.device_store and t.store_sharded
    assert t._dev_states.rows_per_shard == -(-total // 2) and t._dev_states.start == 0
    assert not _trainer(None).device_store  # one card, no mesh: streamed
    with pytest.raises(ValueError, match="needs a mesh"):
        _trainer(None, shard_store=True)
    with pytest.raises(ValueError, match="resident store"):
        _trainer(mesh, shard_store=True, device_store=False)
    with pytest.raises(ValueError, match="does not divide"):
        _trainer(Mesh(MeshConfig(), 3, 1, 0))
