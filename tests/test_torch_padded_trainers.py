"""The port's padded training route against the JAX package's, epoch by
epoch, on a cut of bench.py's trained-metrics fixture (200 train and 100
val rows of the learnable synthetic fixture, d=64, lr 3e-4, batch 128; one
history bucket of 32, which holds every history of up to 19 clicks, so that
each package compiles one step), from one numpy-seeded set of weights, on
the CPU, with dropout off:
``TowerTrainer(flat_train=False, flat_eval=False)`` for ``final_attention``
and ``transformer``, ``JointTowerTrainer`` (a blend over a content baseline
and a reducer) and ``ClassificationTrainer``; then save and restore with
dropout on, and ``configs.run_config1`` for a padded tower."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.train import trainer as jax_trainer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.configs import run_config1
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.eval.ranker import compose_final_scores
from news_recommendation_project_v2_torch.models import build_tower, convert, towers
from news_recommendation_project_v2_torch.train.trainer import ClassificationTrainer, JointTowerTrainer, TowerTrainer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 64
CFGS = {
    "final_attention": TowerConfig(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=128, dropout_rate=0.0),
    "transformer": TowerConfig(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=1, dropout_rate=0.0),
}
TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=128, seed=0)
BUCKETS = (32,)
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


@pytest.fixture(scope="module")
def fixture():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=200, num_rows=300, dim=D, noise=0.05, seed=7)
    ct = compile_behaviors(imps[:200], hist[:200]).with_history_view()
    cv = compile_behaviors(imps[200:], hist[200:]).with_history_view()
    jct = jax_compile(imps[:200], hist[:200]).with_history_view()
    jcv = jax_compile(imps[200:], hist[200:]).with_history_view()
    return dict(
        ct=ct, cv=cv, jct=jct, jcv=jcv,
        emb_t=align_embeddings(ct.news_ids, emb), emb_v=align_embeddings(cv.news_ids, emb),
    )


def _jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _tower(cfg: TowerConfig):
    params = convert.random_tower_params(np.random.default_rng(0), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.tower_state_dict_from_jax(cfg.kind, params), strict=True)
    return tower, jax.tree.map(jnp.asarray, params)


def _jax_tables(f):
    return dict(
        compiled_train=f["jct"], news_emb_train=jnp.asarray(f["emb_t"]),
        compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]),
    )


def _assert_same_history(port, want, loss_rel=1e-5):
    """Each epoch's pair-weighted loss within a relative 1e-5 and its
    metrics within 2e-3 (an AUC moves by about 2e-4 per pair of candidates
    whose order flips; the two sum in other orders, and Adam carries that
    through the epochs' steps)."""
    assert [h["epoch"] for h in port] == [h["epoch"] for h in want] == [1, 2]
    for got, ref in zip(port, want):
        assert got["loss"] == pytest.approx(ref["loss"], rel=loss_rel)
        for split in ("train", "val"):
            assert got[split]["num_samples"] == ref[split]["num_samples"]
            for k in METRICS:
                assert got[split][k] == pytest.approx(ref[split][k], abs=2e-3), (got["epoch"], split, k)


@pytest.mark.parametrize("kind", list(CFGS))
def test_padded_tower_trainer_matches_jax(fixture, kind):
    f = fixture
    tower, params = _tower(CFGS[kind])
    port = TowerTrainer(
        tower, f["ct"], f["emb_t"], compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=TrainConfig(**TRAIN),
        buckets=BUCKETS, flat_train=False, flat_eval=False, device="cpu",
    ).train()
    want = jax_trainer.TowerTrainer(
        jax_build_tower(_jax_cfg(CFGS[kind])).apply, params, cfg=JaxTrainConfig(**TRAIN), buckets=BUCKETS,
        **_jax_tables(f),
    ).train()
    _assert_same_history(port, want)
    assert port[-1]["loss"] < port[0]["loss"]


def _classification(f, loss):
    params = convert.random_classification_head_params(np.random.default_rng(3), D, D)
    head = towers.ClassificationHead(D, D)
    head.load_state_dict(convert.classification_head_state_dict_from_jax(params))
    cfg = dict(TRAIN, loss=loss)
    port = ClassificationTrainer(
        head, f["ct"], f["emb_t"], compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=TrainConfig(**cfg), device="cpu"
    )
    jt = jax_trainer.ClassificationTrainer(
        jax_towers.ClassificationHead(D, D).apply, jax.tree.map(jnp.asarray, params), f["jct"], jnp.asarray(f["emb_t"]),
        compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]), cfg=JaxTrainConfig(**cfg),
    )
    return port, jt


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_classification_trainer_matches_jax(fixture, loss):
    """Two epochs; the last epoch's val metrics are those of
    ``baseline_scores``, the scores per unique news the joint trainer's
    blend takes."""
    port, jt = _classification(fixture, loss)
    history = port.train()
    _assert_same_history(history, jt.train())
    preds = port.baseline_scores(fixture["emb_v"])
    assert preds.shape == (fixture["cv"].num_news,) and preds.dtype == np.float32
    assert compose_final_scores(fixture["cv"], baseline_scores=preds).metrics == history[-1]["val"]


def test_joint_trainer_matches_jax(fixture):
    """The final_attention tower with a blend over a trained content
    scorer's baseline and a reducer, under one optimizer; both packages
    get the same baselines."""
    f = fixture
    head_trainer = _classification(f, "margin")[0]
    head_trainer.train(1)
    base_t, base_v = head_trainer.baseline_scores(f["emb_t"]), head_trainer.baseline_scores(f["emb_v"])
    rng = np.random.default_rng(5)
    blend_p, reduce_p = convert.random_weighted_sum_params(rng), convert.random_reducing_params(rng, D, D)
    blend, reduce = towers.WeightedSumModel(), towers.ReducingModel(D, D)
    blend.load_state_dict(convert.weighted_sum_state_dict_from_jax(blend_p))
    reduce.load_state_dict(convert.reducing_state_dict_from_jax(reduce_p))
    tower, params = _tower(CFGS["final_attention"])
    port = JointTowerTrainer(
        tower, f["ct"], f["emb_t"], blend=blend, reduce=reduce, baseline_train=base_t, baseline_val=base_v,
        compiled_val=f["cv"], news_emb_val=f["emb_v"], cfg=TrainConfig(**TRAIN), buckets=BUCKETS, flat_eval=False,
        device="cpu",
    )
    jt = jax_trainer.JointTowerTrainer(
        jax_build_tower(_jax_cfg(CFGS["final_attention"])).apply, params, f["jct"], jnp.asarray(f["emb_t"]),
        blend_apply=jax_towers.WeightedSumModel().apply, blend_params=jax.tree.map(jnp.asarray, blend_p),
        reduce_apply=jax_towers.ReducingModel(D, D).apply, reduce_params=jax.tree.map(jnp.asarray, reduce_p),
        baseline_train=base_t, baseline_val=base_v,
        compiled_val=f["jcv"], news_emb_val=jnp.asarray(f["emb_v"]), cfg=JaxTrainConfig(**TRAIN), buckets=BUCKETS,
    )
    _assert_same_history(port.train(), jt.train())
    assert set(port.model) == {"tower", "blend", "reduce"}
    assert port._alpha() == pytest.approx(jt._alpha(), abs=1e-5)


def test_padded_resume_with_dropout_is_bit_for_bit(fixture, tmp_path):
    """Dropout on (rate 0.1, masks from the trainer's generator): a run
    saved after epoch 1 and restored into a fresh trainer continues an
    uninterrupted run bit for bit, the generator's state included."""
    f = fixture
    cfg = dataclasses.replace(CFGS["final_attention"], dropout_rate=0.1)

    def trainer():
        return TowerTrainer(
            _tower(cfg)[0], f["ct"], f["emb_t"], compiled_val=f["cv"], news_emb_val=f["emb_v"],
            cfg=TrainConfig(**dict(TRAIN, plateau_patience=1)), flat_train=False, flat_eval=False, device="cpu",
        )

    whole = trainer()
    whole.train(2)
    first = trainer()
    first.train(1)
    first.save_training_state(tmp_path / "state")
    resumed = trainer()
    assert resumed.restore_training_state(tmp_path / "state") == 1
    resumed.train(1)
    assert resumed.history == whole.history
    for (name, a), b in zip(resumed.tower.state_dict().items(), whole.tower.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())


def test_run_config1_trains_a_padded_tower():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=60, num_rows=50, dim=16, noise=0.05, seed=3)
    c = compile_behaviors(imps, hist)
    e = align_embeddings(c.news_ids, emb)
    tower_cfg = TowerConfig(kind="transformer", reduced_dim=16, embedding_dim=16)
    got = run_config1(c, e, c, e, train_cfg=TrainConfig(num_epochs=1, batch_size=64), tower_cfg=tower_cfg, device="cpu")
    assert set(got) == {*METRICS, "num_samples"} and got["num_samples"] == 50
    assert all(0.0 <= got[k] <= 1.0 for k in METRICS)
