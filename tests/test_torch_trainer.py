"""The port's ``TowerTrainer`` (``train.trainer``) against the JAX package's
on bench.py's trained-metrics fixture (``bench_trained_metrics``: 600 train
and 200 val rows of the learnable synthetic fixture, d=64, 8 latents of 8
heads x 16, lr 3e-4, batch 128), from one numpy-seeded set of weights, on
the CPU; its plateau scheduler, save and restore, and ``configs.run_config1``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops import scoring as jax_scoring
from news_recommendation_project_v2_tpu.train import trainer as jax_trainer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.configs import run_config1
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import latent_state_dict_from_jax, random_latent_params
from news_recommendation_project_v2_torch.train.checkpoint import load_pytree
from news_recommendation_project_v2_torch.train.trainer import PlateauScheduler, TowerTrainer, make_optimizer

D = 64
TOWER = dict(kind="latent", reduced_dim=D, num_latents=8, latent_dim_head=16)
TRAIN = dict(learning_rate=3e-4, num_epochs=3, batch_size=128, seed=0)
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


@pytest.fixture(scope="module")
def fixture():
    """bench_trained_metrics' data, compiled by both packages, and one set of
    tower weights."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=200, num_rows=800, dim=D, noise=0.05, seed=7)
    ct = compile_behaviors(imps[:600], hist[:600]).with_history_view()
    cv = compile_behaviors(imps[600:], hist[600:]).with_history_view()
    jct = jax_compile(imps[:600], hist[:600]).with_history_view()
    jcv = jax_compile(imps[600:], hist[600:]).with_history_view()
    params = random_latent_params(np.random.default_rng(0), TowerConfig(**TOWER))
    return dict(
        ct=ct, cv=cv, jct=jct, jcv=jcv, params=params,
        emb_t=align_embeddings(ct.news_ids, emb), emb_v=align_embeddings(cv.news_ids, emb),
    )


def _trainer(f, device_metrics=True, **kwargs):
    tower = build_tower(TowerConfig(**TOWER))
    tower.load_state_dict(latent_state_dict_from_jax(f["params"]))
    cfg = TrainConfig(**{**TRAIN, **kwargs.pop("cfg", {})})
    return TowerTrainer(
        tower, f["ct"], f["emb_t"], compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=cfg,
        device_metrics=device_metrics, device="cpu", **kwargs,
    )


@pytest.fixture(scope="module", params=[True, False], ids=["device_metrics", "host_metrics"])
def runs(request, fixture):
    """Three epochs of each package's trainer. The JAX package's flat eval
    sizes its token chunk from a 16 GiB budget (524,288 tokens, nearly all
    pad at this size); both take the chunk the port picks for this data
    (8,192 tokens), which changes no value beyond float32 summation order."""
    f = fixture
    port = _trainer(f, request.param).train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_scoring, "_auto_flat_chunk", lambda out_dim: 8192)
        jtower = jax_build_tower(JaxTowerConfig(**TOWER))
        jt = jax_trainer.TowerTrainer(
            jtower.apply, jax.tree.map(jnp.asarray, f["params"]), f["jct"], jnp.asarray(f["emb_t"]),
            compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]), cfg=JaxTrainConfig(**TRAIN),
            flat_train=True, flat_eval=True, device_metrics=request.param,
        )
        return port, jt.train()


def test_trainer_matches_jax_epoch_by_epoch(runs):
    """Each epoch's pair-weighted loss within a relative 1e-5 and its train
    and val metrics within 2e-3 (an AUC moves by about 2e-4 per pair of
    candidates whose order flips; the two sum in other orders, and Adam
    carries that through some 40 steps)."""
    port, jax_history = runs
    assert [h["epoch"] for h in port] == [h["epoch"] for h in jax_history] == [1, 2, 3]
    for got, want in zip(port, jax_history):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for split in ("train", "val"):
            assert got[split]["num_samples"] == want[split]["num_samples"]
            for k in METRICS:
                assert got[split][k] == pytest.approx(want[split][k], abs=2e-3), (got["epoch"], split, k)


def test_trainer_learns(runs):
    """The gate bench.py holds the JAX package to: best val AUC above 0.58;
    and the loss falls."""
    port, _ = runs
    assert max(h["val"]["auc"] for h in port) > 0.58
    assert port[-1]["loss"] < port[0]["loss"]


def test_plateau_scheduler_matches_jax():
    """The same val metrics give the same learning-rate sequence, the port's
    set on every parameter group."""
    cfg = dict(learning_rate=1e-3, plateau_patience=1, plateau_factor=0.1)
    sched, jsched = PlateauScheduler(TrainConfig(**cfg)), jax_trainer.PlateauScheduler(JaxTrainConfig(**cfg))
    opt = make_optimizer(TrainConfig(**cfg), [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))])
    jopt = jax_trainer.make_optimizer(JaxTrainConfig(**cfg))
    state = jopt.init({"w": jnp.zeros(3)})
    lrs = []
    for metric in (0.5, 0.4, 0.4, 0.6, 0.6, 0.55, 0.55, None, 0.7):
        sched.update(opt, metric)
        state = jsched.update(state, metric)
        want = float(state[1].hyperparams["learning_rate"])
        assert sched.lr == jsched.lr
        assert all(g["lr"] == sched.lr for g in opt.param_groups)
        assert np.float32(sched.lr) == want
        lrs.append(sched.lr)
    assert lrs[0] == 1e-3 and lrs[-1] == pytest.approx(1e-5)


def test_save_and_restore_resume_bit_for_bit(fixture, tmp_path):
    """Save after epoch 1 and restore into a fresh trainer: its epoch 2
    (loss, metrics, parameters, the next sampling draw) equals an
    uninterrupted run's, bit for bit on the CPU. Logs and checkpoints are
    written."""
    f = fixture

    def trainer(run):
        return _trainer(
            f, cfg=dict(plateau_patience=1, loss="infonce"), exp_name="x",
            log_dir=tmp_path / run / "logs", ckpt_dir=tmp_path / run / "ckpt",
        )

    whole = trainer("whole")
    whole.train(2)
    first = trainer("parts")
    first.train(1)
    first.save_training_state(tmp_path / "state")
    resumed = trainer("parts")
    assert resumed.restore_training_state(tmp_path / "state") == 1
    resumed.train(1)
    assert resumed.history == whole.history
    for (name, a), b in zip(resumed.tower.state_dict().items(), whole.tower.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.optimizer.param_groups[0]["lr"] == whole.optimizer.param_groups[0]["lr"]
    assert resumed.plateau.__dict__ == whole.plateau.__dict__
    assert resumed.best.best_score == whole.best.best_score > -np.inf
    assert resumed.rng.bit_generator.state == whole.rng.bit_generator.state
    logs = (tmp_path / "parts" / "logs" / name for name in ("train", "eval"))
    assert [len(p.with_name(f"{p.name}_final_history_score.jsonl").read_text().splitlines()) for p in logs] == [2, 2]
    best = load_pytree(whole.best.best_path)
    assert (tmp_path / "whole" / "ckpt" / "Epoch_2").exists() and set(best) == set(whole.tower.state_dict())


def test_run_config1_returns_the_metrics(fixture):
    imps, hist, emb = synthetic_learnable_behaviors(num_news=60, num_rows=50, dim=16, noise=0.05, seed=3)
    c = compile_behaviors(imps, hist)
    e = align_embeddings(c.news_ids, emb)
    got = run_config1(c, e, c, e, train_cfg=TrainConfig(num_epochs=1, batch_size=64), device="cpu")
    assert set(got) == {*METRICS, "num_samples"} and got["num_samples"] == 50
    assert all(0.0 <= got[k] <= 1.0 for k in METRICS)


def test_trainer_refuses_what_is_not_ported(fixture):
    f = fixture
    tower = build_tower(TowerConfig(**TOWER))
    for kwargs in (dict(flat_train=False, flat_eval=True), dict(flat_train=True, flat_eval=False)):
        with pytest.raises(NotImplementedError, match="flat"):
            TowerTrainer(tower, f["ct"], f["emb_t"], device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="mesh"):
        TowerTrainer(tower, f["ct"], f["emb_t"], mesh=object(), device="cpu")
