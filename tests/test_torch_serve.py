"""The port's serving path (``serve.Ranker`` and ``cli.serve``) against the
JAX package's on the same weights, table and requests, on the CPU."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.cli import serve as jax_cli
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops.encode import save_embeddings as jax_save_embeddings
from news_recommendation_project_v2_tpu.serve import Ranker as JaxRanker
from news_recommendation_project_v2_tpu.train.checkpoint import save_pytree
from news_recommendation_project_v2_torch.cli import serve as port_cli
from news_recommendation_project_v2_torch.config import TowerConfig, tower_kwargs_for_dim
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
)
from news_recommendation_project_v2_torch.serve import Ranker
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D, NUM_NEWS = 32, 700
CFG = TowerConfig(kind="latent", **tower_kwargs_for_dim(D))
JAX_CFG = JaxTowerConfig(kind="latent", **tower_kwargs_for_dim(D))
IDS = [f"N{i}" for i in range(NUM_NEWS)]


@pytest.fixture(scope="module")
def world():
    """One seeded set of weights and table, and a ranker of each package."""
    rng = np.random.default_rng(7)
    params = random_latent_params(rng, CFG)
    emb = (rng.standard_normal((NUM_NEWS, D)) * 0.5).astype(np.float32)
    tower = build_tower(CFG)
    tower.load_state_dict(latent_state_dict_from_jax(params), strict=True)
    jt = jax_build_tower(JAX_CFG)
    port = Ranker(tower, emb, IDS, device="cpu")
    ref = JaxRanker(lambda p, e, m: jt.apply(p, e, m), params, emb, IDS)
    return dict(params=params, emb=emb, port=port, ref=ref)


def assert_same_ranking(got, want, atol=1e-5):
    assert [c for c, _ in got] == [c for c, _ in want]
    a = np.array([s for _, s in got], dtype=np.float64)
    b = np.array([s for _, s in want], dtype=np.float64)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], atol=atol)


REQUESTS = [
    (["N0", "N5", "N9"], ["N1", "N2", "N3", "N4"]),
    (["NMISSING", "N17"], ["N40", "NUNKNOWN", "N41", "N42", "N43"]),
    ([f"N{i}" for i in range(20, 45)], [f"N{i}" for i in range(100, 120)]),
    (["N3"], [f"N{i}" for i in range(420)]),  # beyond the largest bucket
]


@pytest.mark.parametrize("req", range(len(REQUESTS)))
def test_rank_matches_jax(world, req):
    assert_same_ranking(world["port"].rank(*REQUESTS[req]), world["ref"].rank(*REQUESTS[req]))


@pytest.mark.parametrize("k", [1, 10])
def test_retrieve_matches_jax(world, k):
    hist = [f"N{i}" for i in range(50, 70)]
    assert_same_ranking(world["port"].retrieve(hist, k=k), world["ref"].retrieve(hist, k=k))


def test_rank_batch_matches_jax(world):
    got, want = world["port"].rank_batch(REQUESTS), world["ref"].rank_batch(REQUESTS)
    assert len(got) == len(want) == len(REQUESTS)
    for g, w in zip(got, want):
        assert_same_ranking(g, w)


def test_rank_dense_matches_jax(world):
    hist, cands = REQUESTS[2]
    np.testing.assert_array_equal(
        world["port"].rank_dense(hist, cands), world["ref"].rank_dense(hist, cands)
    )


def test_unknown_candidates_score_neg_inf_and_rank_last(world):
    out = world["port"].rank(["N1"], ["N5", "NUNKNOWN", "N6"])
    assert out[-1] == ("NUNKNOWN", -np.inf)


def test_cold_start_raises(world):
    r = world["port"]
    for call in (
        lambda: r.rank(["NMISSING"], ["N1"]),
        lambda: r.retrieve(["NMISSING"]),
        lambda: r.rank_batch([(["NMISSING"], ["N1"])]),
    ):
        with pytest.raises(ValueError, match="no known history ids"):
            call()


@pytest.mark.parametrize("n", [350, 600])
def test_more_than_300_candidates_are_chunked(world, n):
    r = world["port"]
    assert r._chunk_sizes(n) == [300] * (-(-n // 300))
    cands = [f"N{i}" for i in range(n)]
    assert_same_ranking(r.rank(["N0", "N1"], cands), world["ref"].rank(["N0", "N1"], cands))


def test_mesh_raises(world):
    """Mesh serving (``tests/test_torch_mesh_serve.py``) refuses a data axis
    that is no power of two, as the JAX package asserts."""
    from news_recommendation_project_v2_torch.config import MeshConfig
    from news_recommendation_project_v2_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="power-of-two data axis"):
        Ranker(lambda e, m: e.mean(1), world["emb"], IDS, mesh=Mesh(MeshConfig(), 3, 1, 0), device="cpu")


# -- the CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(world, tmp_path_factory):
    """An embedding dump written by the JAX package's save_embeddings, the
    tower as a port ``.pt`` state_dict and as a JAX (Orbax) checkpoint."""
    root = tmp_path_factory.mktemp("serve_artifacts")
    jax_save_embeddings(root / "emb", "dev", world["emb"], query_embeddings=world["emb"],
                        news_ids=np.array(IDS))
    torch.save(latent_state_dict_from_jax(world["params"]), root / "tower.pt")
    save_pytree(root / "orbax", world["params"])
    return root


JSONL = [
    {"op": "rank", "history": ["N0", "N7"], "candidates": ["N1", "NOPE", "N2", "N3"]},
    {"op": "retrieve", "history": ["N4", "N5"], "k": 5},
    {"op": "rank_batch", "requests": [
        {"history": ["N0"], "candidates": ["N1", "N2"]},
        {"history": ["N3", "N9", "N11"], "candidates": [f"N{i}" for i in range(30, 340)]},
    ]},
    {"op": "bogus"},
    "not an object",
    {"op": "rank", "history": ["NMISSING"], "candidates": ["N1"]},
]


def _stdio(cli, ranker):
    out = io.StringIO()
    cli.serve_stdio(ranker, stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in JSONL)), stdout=out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _same_pairs(got, want):
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert (a is None and b is None) or a == pytest.approx(b, abs=1e-5)


@pytest.mark.parametrize("with_ckpt", [True, False], ids=["latent_ckpt", "mean_pool"])
def test_cli_build_ranker_and_stdio_match_jax(artifacts, with_ckpt):
    emb_dir = artifacts / "emb"
    port = port_cli.build_ranker(
        emb_dir, "dev", artifacts / "tower.pt" if with_ckpt else None, CFG, device="cpu"
    )
    ref = jax_cli.build_ranker(emb_dir, "dev", artifacts / "orbax" if with_ckpt else None, JAX_CFG)
    got, want = _stdio(port_cli, port), _stdio(jax_cli, ref)
    assert len(got) == len(want) == len(JSONL)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "ranked" in g:
            _same_pairs(g["ranked"], w["ranked"])
        elif "results" in g:
            for a, b in zip(g["results"], w["results"], strict=True):
                _same_pairs(a, b)
    assert got[3] == want[3]  # the unknown-op message


def test_cli_main_stdio_on_cpu(artifacts, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(JSONL[1]) + "\n"))
    port_cli.main([str(artifacts / "emb"), "dev", "--ckpt", str(artifacts / "tower.pt"),
                   "--dim", str(D), "--device", "cpu", "--stdio"])
    out = json.loads(capsys.readouterr().out.strip())
    assert len(out["ranked"]) == 5


def test_http_round_trip(artifacts):
    r = port_cli.build_ranker(artifacts / "emb", "dev", device="cpu")
    server = port_cli.make_server(r, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["news"] == NUM_NEWS
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/rank",
            data=json.dumps({"history": ["N0"], "candidates": ["N1", "N0"]}).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["ranked"][0][0] == "N0"
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/rank", data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_warmup_runs_every_bucket(artifacts):
    r = port_cli.build_ranker(artifacts / "emb", "dev", device="cpu")
    r.buckets, r.candidate_buckets = (2, 4), (2, 8)
    assert r.warmup() == 2 * (2 + 1)  # 2 history buckets x (2 candidate buckets + 1 retrieve)
    assert r.warmup(batch_sizes=(3,)) == 2 * (2 + 1 + 2)


def test_build_ranker_checks_its_inputs(tmp_path, artifacts):
    jax_save_embeddings(tmp_path, "dev", np.zeros((4, D), np.float32))  # positional-only
    with pytest.raises(FileNotFoundError, match="id-keyed"):
        port_cli.build_ranker(tmp_path, "dev", device="cpu")
    wide = TowerConfig(kind="latent", reduced_dim=2 * D)
    with pytest.raises(ValueError, match="reduced_dim"):
        port_cli.build_ranker(artifacts / "emb", "dev", artifacts / "tower.pt", wide, device="cpu")


@pytest.mark.parametrize("kind", ["final_attention", "transformer"])
def test_cli_main_serves_other_towers(world, artifacts, monkeypatch, capsys, kind):
    """``nrtorch-serve --tower final_attention|transformer --stdio`` over a
    ``torch.save``d state_dict of that tower: every response within 1e-5 of
    the JAX package's Ranker on the same weights, in the same order."""
    from news_recommendation_project_v2_torch.models.convert import random_tower_params, tower_state_dict_from_jax

    cfg = TowerConfig(kind=kind, **tower_kwargs_for_dim(D))
    params = random_tower_params(np.random.default_rng(9), cfg)
    torch.save(tower_state_dict_from_jax(kind, params), artifacts / f"{kind}.pt")
    lines = [r for r in JSONL if isinstance(r, dict) and r["op"] != "bogus"]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(json.dumps(r) + "\n" for r in lines)))
    port_cli.main([str(artifacts / "emb"), "dev", "--ckpt", str(artifacts / f"{kind}.pt"), "--tower", kind,
                   "--dim", str(D), "--device", "cpu", "--stdio"])
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    jt = jax_build_tower(JaxTowerConfig(kind=kind, **tower_kwargs_for_dim(D)))
    ref = JaxRanker(lambda p, e, m: jt.apply(p, e, m), params, world["emb"], IDS)
    out = io.StringIO()
    jax_cli.serve_stdio(ref, stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in lines)), stdout=out)
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(got) == len(want) == len(lines)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "ranked" in g:
            _same_pairs(g["ranked"], w["ranked"])
        elif "results" in g:
            for a, b in zip(g["results"], w["results"], strict=True):
                _same_pairs(a, b)
        else:
            assert set(g) == {"error"}
