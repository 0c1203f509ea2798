"""The port's sharded forward functions and config[4] on meshes of CPU ranks
(gloo), against the JAX package.

One spawn of two ranks (``parallel.mesh.launch``; rank code in
``torch_mesh_workers``, which loads no JAX) runs meshes (2, 1) and (1, 2);
``tests/test_torch_mesh_e2e.py``'s world of four runs the forward checks
on mesh (2, 2) and holds them with ``check_forward`` below. Against the
JAX package's single-device functions at the shapes and tolerances of its
mesh tests (``tests/test_sharding.py``):

- ``make_sequence_sharded_tower_fn`` (B = 8, L = 16, d = 32): the latent
  tower against the JAX tower within 1e-5; final_attention, which reads
  the whole history, against the port's own tower within 1e-5;
- ``make_sharded_encode_fn`` over 8 texts against the JAX ``NewsEncoder``
  within 1e-5;
- ``shard_encoder_params_tp`` for the BERT/e5 layout and NV-Embed's (a
  decoder backbone and the latent head): outputs within 1e-5 of the JAX
  encoder, the split leaves exactly the JAX rule's (its
  ``shard_encoder_params_tp`` on the JAX package's 8-device mesh, its
  sharded leaves mapped to the port's names through
  ``models.convert.encoder_state_dict_from_jax``), each split to its
  share;
- ``configs.run_config4`` on the fixture of
  ``tests/test_baseline_configs.py::test_config4_multihost_pipeline_runs``,
  without and with the tower's training, against the JAX ``run_config4``
  on its (4, 2) mesh from the same weights (metrics 1e-6); config[0]'s
  metrics link by link (``_config0_chain`` says why): the mesh run against
  the port's one-rank pipeline, its scores against the JAX package's, and
  the JAX package's metrics of those scores, each 1e-6.

Then ``nrtorch-reproduce --cpu-ranks 2`` runs configs 3-4 on two gloo
ranks (the tool's own spawn), and the flag refuses CUDA.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from news_recommendation_project_v2_torch.cli import reproduce
from news_recommendation_project_v2_torch.config import EncoderConfig, TowerConfig
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    encoder_state_dict_from_jax,
    random_encoder_params,
    random_tower_params,
    tower_state_dict_from_jax,
)
from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer
from news_recommendation_project_v2_torch.parallel import launch
from news_recommendation_project_v2_tpu import configs as jax_configs
from news_recommendation_project_v2_tpu.config import EncoderConfig as JaxEncoderConfig
from news_recommendation_project_v2_tpu.config import MeshConfig as JaxMeshConfig
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from news_recommendation_project_v2_tpu.parallel import build_mesh as jax_build_mesh
from news_recommendation_project_v2_tpu.parallel.sharding import shard_encoder_params_tp as jax_shard_tp
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


def _jax_config(cfg):
    """The JAX package's config of the port's ``cfg``: its own fields (the
    port's DeepSeek-V3 fields have no counterpart there)."""
    return JaxEncoderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxEncoderConfig)})

D = workers.D
SHAPES = [(2, 1), (1, 2)]
IDS = ["mesh2x1", "mesh1x2"]
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")
TP_LAYOUTS = {"tp_bert": dict(workers.SMALL_ENCODER, num_layers=2), "tp_nv_embed": workers.SMALL_NV_EMBED}

FORWARD_PARTS = ["sequence", "encode", *TP_LAYOUTS]


@pytest.fixture(scope="module")
def runs():
    two = launch(workers.encode_worker, 2, args=(SHAPES,), backend="gloo", timeout=600)
    return dict(
        forward={shape: [r[shape]["forward"] for r in two] for shape in SHAPES},
        config4={shape: [r[shape]["config4"] for r in two] for shape in SHAPES},
    )


def _jax_encoder(cfg_kwargs: dict):
    cfg = EncoderConfig(**cfg_kwargs)
    return JaxNewsEncoder(_jax_config(cfg)), jax.tree.map(jnp.asarray, random_encoder_params(cfg, 0))


def _jax_encode(cfg_kwargs: dict, texts: list) -> np.ndarray:
    enc, params = _jax_encoder(cfg_kwargs)
    ids, mask = HashTokenizer(96, 12)(texts)
    return np.asarray(enc.apply(params, jnp.asarray(ids), jnp.asarray(mask)))


def _jax_split_leaves(cfg_kwargs: dict) -> list[str]:
    """The JAX rule's split leaves under the port's names: each leaf of the
    JAX parameters filled with its own index, converted by
    ``encoder_state_dict_from_jax``; a port weight is split when its index's
    JAX leaf is not fully replicated on the JAX package's (4, 2) mesh."""
    cfg = EncoderConfig(**cfg_kwargs)
    params = random_encoder_params(cfg, 0)
    mesh = jax_build_mesh(JaxMeshConfig(data_size=4, model_size=2))
    leaves, treedef = jax.tree_util.tree_flatten(jax_shard_tp(mesh, jax.tree.map(jnp.asarray, params)))
    split = {i for i, leaf in enumerate(leaves) if not leaf.sharding.is_fully_replicated}
    marked = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    return sorted(k for k, v in encoder_state_dict_from_jax(marked, cfg).items() if int(v.reshape(-1)[0]) in split)


def check_forward(part: str, ranks: list, model: int) -> None:
    """Hold every rank's ``part`` of ``workers.forward_checks`` (a mesh with
    ``model`` ranks on its model axis) to the JAX package (the module
    docstring)."""
    if part == "sequence":
        emb, mask = workers.sequence_inputs()
        tower = jax_build_tower(JaxTowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8))
        want = np.asarray(tower.apply(jax.tree.map(jnp.asarray, workers.numpy_params()["tower"]), emb, mask))
        fa = build_tower(workers.FINAL_ATTENTION)
        fa.load_state_dict(tower_state_dict_from_jax(
            "final_attention", random_tower_params(np.random.default_rng(4), workers.FINAL_ATTENTION)))
        with torch.inference_mode():
            want_fa = fa.eval()(torch.as_tensor(emb), torch.as_tensor(mask)).numpy()
        for rank in ranks:
            np.testing.assert_allclose(rank["seq_latent"], want, atol=1e-5)
            np.testing.assert_allclose(rank["seq_final_attention"], want_fa, atol=1e-5)
        return
    if part == "encode":
        want = _jax_encode(dict(workers.SMALL_ENCODER, num_layers=1), workers.encode_texts()[0])
        for rank in ranks:
            np.testing.assert_allclose(rank["encode"], want, atol=1e-5)
        return
    cfg = TP_LAYOUTS[part]
    want = _jax_encode(cfg, workers.encode_texts()[1])
    split = _jax_split_leaves(cfg)
    assert split  # the rule splits something in both layouts
    for rank in ranks:
        got = rank[part]
        np.testing.assert_allclose(got["out"], want, atol=1e-5)
        assert got["split"] == split
        for k, whole in got["whole"].items():
            local = got["local"][k]
            if k not in split:
                assert local == whole, k
            elif k.endswith("output.dense.weight"):
                assert local == (whole[0], whole[1] // model), k  # row-parallel: its input features
            else:
                assert local == (whole[0] // model, whole[1]), k  # column-parallel: its output features


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("part", FORWARD_PARTS)
def test_forward_functions_match_jax(runs, shape, part):
    check_forward(part, runs["forward"][shape], shape[1])


def _jax_config4(train: bool) -> dict:
    imps, hist, _, ids, mask = workers.config4_fixture()
    jc = jax_compile(imps, hist)
    enc, params = _jax_encoder(workers.CONFIG4_ENCODER)
    mesh_cfg = JaxMeshConfig(data_size=4, model_size=2)
    if not train:
        return jax_configs.run_config4(jc, ids, mask, lambda p, i, m: enc.apply(p, i, m), params, mesh_cfg=mesh_cfg)
    tower_cfg = TowerConfig(**workers.CONFIG4_TOWER)
    tower_params = random_tower_params(np.random.default_rng(workers.CONFIG4_TRAIN["seed"]), tower_cfg)
    build = jax_configs.build_tower

    class FixedInit:
        """The JAX run_config3's tower, starting from the port's numpy weights."""

        def __init__(self, cfg):
            self.apply = build(cfg).apply

        def init(self, *args, **kwargs):
            return jax.tree.map(jnp.asarray, tower_params)

    jax_configs.build_tower = FixedInit
    try:
        return jax_configs.run_config4(
            jc, ids, mask, lambda p, i, m: enc.apply(p, i, m), params, mesh_cfg=mesh_cfg,
            train_cfg=JaxTrainConfig(**workers.CONFIG4_TRAIN), tower_cfg=JaxTowerConfig(**workers.CONFIG4_TOWER),
        )
    finally:
        jax_configs.build_tower = build


def _config0_chain() -> tuple[dict, dict]:
    """config[0] on the port's one-rank encode of the fixture: the port's
    ``run_config0`` metrics, and the JAX package's metrics
    (``compose_final_scores``) of the port's per-slot scores, once those
    are held to the JAX package's scores of the same table (1e-6).

    The fixture's mean-pool cosines put two news of one impression (row 20)
    6e-8 apart, under the 2.4e-7 by which the two packages' float32
    cosines of one table differ, so the JAX package's own ``run_config0``
    orders them one way on its encoder's table and the other way on the
    port's (AUC 0.51232 against 0.51274): config[0]'s metrics are held link
    by link, the encode by ``check_forward``."""
    from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
    from news_recommendation_project_v2_torch.models import average_pool
    from news_recommendation_project_v2_torch.ops.scoring import score_all_impressions
    from news_recommendation_project_v2_tpu.eval.ranker import compose_final_scores as jax_compose
    from news_recommendation_project_v2_tpu.models import average_pool as jax_average_pool
    from news_recommendation_project_v2_tpu.ops.scoring import score_all_impressions as jax_score

    from news_recommendation_project_v2_torch.configs import run_config0

    imps, hist, c, ids, mask = workers.config4_fixture()
    enc, _ = workers.encoder_from(workers.CONFIG4_ENCODER)
    with torch.inference_mode():
        emb = enc(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    slots, cand_rows = history_candidate_slots(c)
    view = c.with_history_view()
    grids = (view.hist_rev, view.hist_lens, c.imp_rev[slots], cand_rows)
    scores = score_all_impressions(average_pool, emb, *grids, device="cpu")
    jc = jax_compile(imps, hist)
    want = np.asarray(jax_score(lambda p, e, m: jax_average_pool(e, m), None, jnp.asarray(emb), *grids))
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-6)
    return run_config0(c, emb, device="cpu"), jax_compose(jc, history_scores=np.asarray(scores)).metrics


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("variant", ["config0", "config3"])
def test_run_config4_matches_jax(runs, shape, variant):
    if variant == "config3":
        single = want = _jax_config4(True)
    else:
        single, want = _config0_chain()
    for rank in runs["config4"][shape]:
        got = rank[variant]
        assert got["num_samples"] == want["num_samples"] == single["num_samples"]
        for k in METRICS:
            assert got[k] == pytest.approx(single[k], abs=1e-6), k
            assert single[k] == pytest.approx(want[k], abs=1e-6), k


def test_reproduce_runs_configs_3_and_4_on_cpu_ranks(tmp_path, capsys):
    rows = reproduce.main([
        str(tmp_path / "data"), "--synthetic", "--tiny-encoder", "--epochs", "1", "--device", "cpu",
        "--cpu-ranks", "2", "--out", str(tmp_path / "rows.json"),
    ])
    assert [r["config"] for r in rows] == [0, 1, 3, 4]
    assert json.loads((tmp_path / "rows.json").read_text()) == rows
    for r in rows:
        assert all(0.0 <= r[k] <= 1.0 for k in METRICS), r
    with pytest.raises(SystemExit):
        reproduce.main([str(tmp_path / "data"), "--cpu-ranks", "2"])  # on CUDA one rank runs per GPU
    assert "--cpu-ranks runs configs 3-4 on the CPU" in capsys.readouterr().err
