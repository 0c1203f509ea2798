"""The port's mesh serving (``serve.Ranker(mesh=)``, ``nrtorch-serve
--mesh``) and sharded scoring (``make_sharded_scoring_fn``) on meshes of
CPU ranks (gloo), against the JAX package's single-device ranker and
scoring and the port's own single-device ranker.

One spawn of two ranks (``parallel.mesh.launch``; rank code in
``torch_mesh_workers``, which loads no JAX) runs meshes (1, 2) and (2, 1):
on each, rank 0 answers 22 requests by ``rank`` (two past the largest
candidate bucket), all of them by ``rank_batch`` and two ``retrieve``\\s
(k = 7, and k past the 501-row table, whose shards pad) while rank 1
follows; then the sharded scoring of the JAX package's
``tests/test_sharding.py::test_sharded_scoring_matches`` inputs, and a
silent rank 0, whose follower must fail on the mesh's timeout.
``tests/test_torch_mesh_e2e.py``'s world of four runs the ranker on mesh
(2, 2) and holds it with ``check_serving`` below. Scores within 1e-5 and
the same ids in the same order (unknown candidates last at ``-inf``); the
scoring within 1e-5.

The second spawn is ``torchrun --nproc-per-node 2 -m ...cli.serve --mesh
1,2 --stdio --device cpu``, answering one request on stdin as the
single-process CLI does.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from news_recommendation_project_v2_torch.cli import serve as serve_cli
from news_recommendation_project_v2_torch.config import TowerConfig, tower_kwargs_for_dim
from news_recommendation_project_v2_torch.models.convert import latent_state_dict_from_jax, random_latent_params
from news_recommendation_project_v2_torch.ops.encode import save_embeddings
from news_recommendation_project_v2_torch.parallel import launch
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.serve import Ranker as JaxRanker
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

REPO = Path(__file__).resolve().parents[1]
D = workers.D
SHAPES = [(1, 2), (2, 1)]
IDS = ["mesh1x2", "mesh2x1"]
CALLS = ["rank", "rank_batch", "retrieve"]


def _jax_tower():
    return jax_build_tower(JaxTowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8))


@pytest.fixture(scope="module")
def runs():
    ranks = launch(workers.serve_worker, 2, args=(SHAPES,), backend="gloo", timeout=600)
    table, ids = workers.serve_table()
    tower = _jax_tower()
    jax_ranker = JaxRanker(tower.apply, jax.tree.map(jnp.asarray, workers.numpy_params()["tower"]), table, ids)
    return dict(ranks=ranks, single=workers.serve_calls(workers.serve_ranker(None)), jax=workers.serve_calls(jax_ranker))


def _same(got: list, want: list) -> None:
    assert [c for c, _ in got] == [c for c, _ in want]
    g, w = np.array([s for _, s in got]), np.array([s for _, s in want])
    assert np.array_equal(np.isinf(g), np.isinf(w))
    np.testing.assert_allclose(g[np.isfinite(g)], w[np.isfinite(w)], rtol=0, atol=1e-5)


def check_serving(call: str, ranks: list, single: dict, jax_answers: dict) -> None:
    """Rank 0's answers to ``call`` against the single-device port ranker's
    and the JAX package's; every follower served the same calls."""
    got = ranks[0]["serve"][call]
    for want in (single[call], jax_answers[call]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    served = [r["serve"]["served"] for r in ranks[1:]]
    assert len(set(served)) == 1 and served[0] > 0


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("call", CALLS)
def test_mesh_ranker_matches_single_device(runs, shape, call):
    check_serving(call, [r[shape] for r in runs["ranks"]], runs["single"], runs["jax"])


def jax_scores() -> np.ndarray:
    """``tests/test_sharding.py::test_sharded_scoring_matches``'s reference:
    the JAX tower over the gathered histories, then the cosine."""
    s = workers.scoring_inputs()
    table = s["table"]
    gathered = table[s["hist_idx"]] * s["hist_mask"][..., None]
    user = np.asarray(_jax_tower().apply(jax.tree.map(jnp.asarray, workers.numpy_params()["tower"]), gathered,
                                         s["hist_mask"]))
    u, c = user[s["cand_row"]], table[s["cand_rev"]]
    return (u * c).sum(-1) / (np.maximum(np.linalg.norm(u, axis=-1), 1e-8) * np.maximum(np.linalg.norm(c, axis=-1), 1e-8))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_scoring_matches_jax(runs, shape):
    want = jax_scores()
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[shape]["scoring"], want, atol=1e-5)


def test_follower_fails_when_rank_0_is_silent(runs):
    """The follower raised on the mesh's 3 s timeout, not later."""
    got = runs["ranks"][1]["dead_leader"]
    assert got["error"] == "RuntimeError" and 2.5 <= got["seconds"] < 6.0, got
    assert runs["ranks"][0]["dead_leader"] == dict(leader=True)


def test_keep_alive_ends_before_close_returns():
    """On mesh (1, 2), rank 0 beats every 0.01 s while it answers
    ``rank_batch`` calls, then closes while the beat thread is inside a
    beat: the thread has ended when ``close()`` returns, the follower's
    ``follow()`` returns the number of calls rank 0 sent, the answers equal
    the single-device ranker's, and both ranks exit 0 (``launch`` raises
    otherwise)."""
    leader, follower = launch(workers.keep_alive_worker, 2, backend="gloo", timeout=300)
    assert leader["thread_ended"]
    assert leader["sent"]["beats"] >= workers.KEEP_ALIVE_CALLS + 1
    assert follower["served"] == leader["sent"]["calls"] > 0
    want = workers.serve_ranker(None).rank_batch(workers.serve_requests()[:4])
    assert len(leader["answers"]) == workers.KEEP_ALIVE_CALLS
    for answer in leader["answers"]:
        for g, w in zip(answer, want):
            _same(g, w)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The serving table as an id-keyed dump and the tower's checkpoint."""
    root = tmp_path_factory.mktemp("mesh_serve")
    table, ids = workers.serve_table()
    save_embeddings(root / "emb", "MINDsmall_dev", table, news_ids=np.array(ids))
    cfg = TowerConfig(**tower_kwargs_for_dim(D))  # the CLI's tower at --dim
    tower = workers.build_tower(cfg)
    tower.load_state_dict(latent_state_dict_from_jax(random_latent_params(np.random.default_rng(5), cfg)))
    torch.save(tower.state_dict(), root / "tower.pt")
    return root


def _cli_args(root: Path) -> list[str]:
    return [str(root / "emb"), "MINDsmall_dev", "--ckpt", str(root / "tower.pt"), "--dim", str(D), "--stdio",
            "--device", "cpu"]


def test_serve_cli_on_a_mesh_under_torchrun(dump, monkeypatch, capsys):
    """Rank 0 answers on stdout, rank 1 follows, and both exit 0 once stdin
    ends; the answer equals the single-process CLI's."""
    reqs = workers.serve_requests()
    request = json.dumps({"op": "rank_batch", "requests": [{"history": h, "candidates": c} for h, c in reqs[:4]]})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "news_recommendation_project_v2_torch.cli.serve", *_cli_args(dump), "--mesh", "1,2"],
        input=request + "\n", cwd=dump, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, proc.stdout  # rank 0 alone answers
    monkeypatch.setattr(sys, "stdin", io.StringIO(request + "\n"))
    serve_cli.main(_cli_args(dump))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads(lines[0])
    for g, w in zip(got["results"], want["results"]):
        _same([(c, -np.inf if s is None else s) for c, s in g], [(c, -np.inf if s is None else s) for c, s in w])


def test_serve_cli_mesh_wants_torchrun(dump):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        serve_cli.main(_cli_args(dump) + ["--mesh", "1,2"])
    with pytest.raises(SystemExit):
        serve_cli.main(_cli_args(dump) + ["--mesh", "two"])
