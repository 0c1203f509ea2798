"""Every ``nrtorch-*`` CLI through its ``main(argv)`` with ``--device cpu``
on the synthetic MIND fixture: the chain ingest -> save-emb -> train ->
eval -> serve on one checkpoint, the train pipeline's cache, the inline
encode, reproduce's three rows and train-e2e's metrics; and that the
entry points default to CUDA.

The tiny encoder (``--tiny-encoder``) is 128 wide, so the chain trains the
tower at ``--dim 128``, as the JAX package's CLI tests do; ``--encode-inline``
and ``nrtorch-train-e2e`` run at ``--dim 32``. One epoch each. The eval's
metrics are held to the flat eval computed directly from the same
checkpoint and tables within 1e-5."""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.cli import eval as eval_cli
from news_recommendation_project_v2_torch.cli import ingest as ingest_cli
from news_recommendation_project_v2_torch.cli import reproduce as reproduce_cli
from news_recommendation_project_v2_torch.cli import save_emb as save_emb_cli
from news_recommendation_project_v2_torch.cli import serve as serve_cli
from news_recommendation_project_v2_torch.cli import train as train_cli
from news_recommendation_project_v2_torch.cli import train_e2e as train_e2e_cli
from news_recommendation_project_v2_torch.cli.common import build_context
from news_recommendation_project_v2_torch.config import DataSubset, NewsDataset, TowerConfig, tower_kwargs_for_dim
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.ops.encode import load_embeddings
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan
from news_recommendation_project_v2_torch.pipeline import TransformDataComponent
from news_recommendation_project_v2_torch.train.checkpoint import load_pytree
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SPLITS = ("MINDsmall_train", "MINDsmall_dev")
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")
CPU = ["--device", "cpu"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Both splits ingested and encoded through the CLIs."""
    root = tmp_path_factory.mktemp("mind")
    for name in SPLITS:
        ingest_cli.main([str(root), name, "--synthetic"])
        save_emb_cli.main(
            [str(root), name, "--save-dir", str(root / "emb"), "--tiny-encoder", "--max-length", "24",
             "--batch-size", "16", *CPU]
        )
    return root


def _train(root, *extra):
    return train_cli.main(
        [str(root), "--emb-dir", str(root / "emb"), "--epochs", "1", "--cls-epochs", "1", "--batch-size", "32",
         "--log-dir", str(root / "logs"), "--ckpt-dir", str(root / "models"), *CPU, *extra]
    )


@pytest.fixture(scope="module")
def trained(root):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)  # the pipeline's cache directory
        return _train(root, "--dim", "128")


def test_ingest_and_save_emb_write_the_store_and_the_dump(root):
    for name in SPLITS:
        proc = root / "processed" / name
        assert sorted(p.name for p in proc.iterdir()) == ["behaviors.npz", "entity_embeds.npz", "news.npz"]
        emb, query = load_embeddings(root / "emb", name, with_query=True)
        ids = np.load(root / "emb" / f"{name}_ids.npy")
        assert emb.shape == query.shape == (len(ids), 128) and emb.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1, atol=1e-5)
        assert np.abs(emb - query).max() > 1e-2  # the query side differs
    assert (root / "categories.json").exists() and (root / "sub_categories.json").exists()


def test_train_writes_checkpoints_logs_and_metrics(root, trained, capsys):
    pipe, train_ctx, dev_ctx = trained
    assert [name for name, _, _ in pipe.step_log] == ["init_transform", "load_embedding", "classification", "only_attention"]
    for ctx in (train_ctx, dev_ctx):
        assert all(np.isfinite(ctx["metrics"][k]) and 0 <= ctx["metrics"][k] <= 1 for k in METRICS)
    for sub in ("attention", "classification"):
        assert (root / "models" / sub / "Epoch_1").exists()
        assert (root / "models" / sub / "Best_model_e5_query_latent").exists()
    state = load_pytree(root / "models" / "attention" / "Best_model_e5_query_latent")
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    rec = json.loads((root / "logs" / "final_scores.jsonl").read_text().splitlines()[0])
    assert rec["exp_name"] == "e5_query_latent" and rec["eval_scores"] == dev_ctx["metrics"]


def test_train_rerun_hits_the_cache(root, trained, monkeypatch):
    """The same command again: every step comes from the cache, with the
    same metrics."""
    monkeypatch.chdir(root)
    pipe, train_ctx, dev_ctx = _train(root, "--dim", "128")
    assert [hit for _, _, hit in pipe.step_log] == [True] * 4
    assert dev_ctx["metrics"] == trained[2]["metrics"]


def test_eval_and_serve_load_the_trained_checkpoint(root, trained, monkeypatch, capsys):
    """``nrtorch-eval --ckpt`` over the dev split's with-history rows equals
    the flat eval computed directly from the same checkpoint and tables;
    ``nrtorch-serve --ckpt`` of the same checkpoint answers a rank request."""
    ckpt = root / "models" / "attention" / "Best_model_e5_query_latent"
    ctx = eval_cli.main(
        [str(root), "--dataset", "MINDsmall_dev", "--emb-dir", str(root / "emb"), "--ckpt", str(ckpt), "--dim", "128",
         "--log-dir", str(root / "logs"), *CPU]
    )
    compiled = TransformDataComponent().transform(
        build_context(root, NewsDataset.MINDsmall_dev, data_subset=DataSubset.WITH_HISTORY)
    )["compiled"]
    emb, query = load_embeddings(root / "emb", "MINDsmall_dev", with_query=True, align_to_news_ids=compiled.news_ids)
    tower = build_tower(TowerConfig(kind="latent", **tower_kwargs_for_dim(128)))
    tower.load_state_dict(load_pytree(ckpt))
    slots, rows = history_candidate_slots(compiled)
    view = compiled.with_history_view()
    plan = FlatEvalPlan(view.hist_rev, view.hist_lens, compiled.imp_rev[slots], rows, max_len=600, device="cpu")
    mplan = DeviceMetricsPlan(compiled.imp_lens, compiled.labels_flat, hist_slots=slots, device="cpu")
    direct = plan.metrics(tower, emb, mplan, query_news_emb=query)
    for k in METRICS:
        assert ctx["metrics"][k] == pytest.approx(direct[k], abs=1e-5)

    ids = [str(n) for n in np.load(root / "emb" / "MINDsmall_dev_ids.npy")]
    request = {"op": "rank", "history": ids[:3], "candidates": ids[3:7]}
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(request) + "\n"))
    capsys.readouterr()
    serve_cli.main([str(root / "emb"), "MINDsmall_dev", "--ckpt", str(ckpt), "--dim", "128", "--stdio", *CPU])
    ranked = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ranked"]
    assert sorted(c for c, _ in ranked) == sorted(ids[3:7])
    ranker = serve_cli.build_ranker(
        root / "emb", "MINDsmall_dev", ckpt, TowerConfig(kind="latent", **tower_kwargs_for_dim(128)), device="cpu"
    )
    assert ranked == [[c, s] for c, s in ranker.rank(ids[:3], ids[3:7])]


def test_train_encode_inline_at_dim_32(root, monkeypatch):
    monkeypatch.chdir(root)
    pipe, _, dev_ctx = _train(root, "--encode-inline", "--dim", "32", "--no-cache", "--exp-name", "inline")
    assert [name for name, _, _ in pipe.step_log][1] == "embed"
    assert dev_ctx["news_embeddings"].shape[1] == dev_ctx["query_news_embeddings"].shape[1] == 32
    assert all(0 <= dev_ctx["metrics"][k] <= 1 for k in METRICS)


def test_train_refuses_mesh(root):
    """``--mesh`` in one process asks for one process per rank (torchrun);
    a malformed value is a usage error."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _train(root, "--mesh", "2,1")
    with pytest.raises(SystemExit):
        _train(root, "--mesh", "two")


def test_train_on_a_mesh_under_torchrun(root, tmp_path):
    """``torchrun --nproc-per-node 2 ... --mesh 2,1 --device cpu`` (gloo):
    exits 0, rank 0 alone prints and writes, and the metrics equal the
    single-rank CLI's within 1e-5."""
    argv = [str(root), "--emb-dir", str(root / "emb"), "--epochs", "1", "--cls-epochs", "1", "--batch-size", "32",
            "--dim", "128", "--no-cache", *CPU]
    _, want_train, want_dev = train_cli.main(
        argv + ["--log-dir", str(tmp_path / "logs1"), "--ckpt-dir", str(tmp_path / "models1")]
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "news_recommendation_project_v2_torch.cli.train", *argv, "--mesh", "2,1",
         "--log-dir", str(tmp_path / "logs2"), "--ckpt-dir", str(tmp_path / "models2")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    printed = dict(line.split(" metrics: ", 1) for line in proc.stdout.splitlines() if " metrics: " in line)
    assert sorted(printed) == ["dev", "train"]  # one rank prints
    for split, want in (("train", want_train["metrics"]), ("dev", want_dev["metrics"])):
        got = ast.literal_eval(printed[split])
        assert got["num_samples"] == want["num_samples"]
        for k in METRICS:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (split, k)
    assert (tmp_path / "models2" / "attention" / "Best_model_e5_query_latent").exists()
    assert len((tmp_path / "logs2" / "final_scores.jsonl").read_text().splitlines()) == 1


def test_train_e2e_prints_finite_metrics(root, capsys):
    ctx = train_e2e_cli.main(
        [str(root), "--epochs", "1", "--dim", "32", "--max-length", "24", "--log-dir", str(root / "logs_e2e"),
         "--ckpt-dir", str(root / "models_e2e"), *CPU]
    )
    assert all(np.isfinite(ctx["metrics"][k]) for k in METRICS)
    assert ctx["news_embeddings"].shape[1] == 32
    assert (root / "models_e2e" / "attn_attn" / "Epoch_1").exists()
    assert "metrics:" in capsys.readouterr().out


def test_reproduce_emits_three_config_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = reproduce_cli.main(
        [str(tmp_path), "--synthetic", "--tiny-encoder", "--epochs", "1", "--with-e2e", "--max-length", "24",
         "--out", str(out), *CPU]
    )
    assert [r["config"] for r in rows] == [0, 1, 2]
    assert json.loads(out.read_text()) == rows
    printed = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines() if line.startswith("CONFIG_ROW")]
    assert printed == rows
    for r in rows:
        assert all(np.isfinite(r[k]) and 0 <= r[k] <= 1 for k in METRICS)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_clis_default_to_cuda(root, no_cuda, tmp_path):
    """Without ``--device`` every CLI that runs a model wants CUDA and
    raises here instead of falling back to the CPU."""
    runs = [
        lambda: save_emb_cli.main([str(root), "MINDsmall_dev", "--save-dir", str(tmp_path), "--tiny-encoder"]),
        lambda: train_cli.main([str(root), "--emb-dir", str(root / "emb"), "--dim", "128", "--no-cache"]),
        lambda: eval_cli.main([str(root), "--emb-dir", str(root / "emb"), "--dim", "128"]),
        lambda: train_e2e_cli.main([str(root), "--dim", "32"]),
        lambda: reproduce_cli.main([str(tmp_path), "--tiny-encoder"]),
    ]
    for run in runs:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
