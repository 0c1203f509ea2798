"""The port's end-to-end training route (``train.trainer.EndToEndTrainer``,
``configs.run_config2``, the e2e memory estimators) against the JAX
package's, on the CPU.

The fixture is the learnable synthetic one at d=32 (120 train and 40 val
rows) with token stores whose 2-6 tokens scatter around each news item's
embedding, so the encoder has signal to learn; one history bucket of 32
holds every history and one token bucket of 8 every news, so each package
compiles few shapes. The trainers
start from one numpy-seeded set of weights with dropout off (the port's
layers at rate 0, the JAX encoder applied deterministic) and are held
epoch by epoch: the pair-weighted loss within a relative 1e-5 and the
metrics within 2e-3 (the tolerances of
``tests/test_torch_padded_trainers.py``); after training, each split's
materialized embeddings within a norm-relative 1e-5 (the gradients'
tolerance in ``tests/test_torch_padded_steps.py``: Adam's normalised step
carries rounding differences of the gradients into the weights, so single
elements differ by up to about 5e-5 after two epochs, while the whole
stays within about 3e-6). Then, on the port alone: the
device-resident store against the streamed one with dropout on (the same
bits), the NaN abort, the per-epoch checkpoints and ``remote_sync``, and a
save and restore mid-run that equals the uninterrupted run bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.ops.encode import TokenStore as JaxTokenStore
from news_recommendation_project_v2_tpu.train.trainer import EndToEndTrainer as JaxEndToEndTrainer
from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.configs import run_config2
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower, convert
from news_recommendation_project_v2_torch.ops.encode import TokenStore
from news_recommendation_project_v2_torch.train.checkpoint import load_pytree
from news_recommendation_project_v2_torch.train.trainer import EndToEndTrainer
from news_recommendation_project_v2_torch.utils import memory
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
TOWER = dict(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, num_heads=2, latent_dim_head=16)
TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=32, seed=0)
BUCKETS = (32,)
# Both packages' trainers read their token buckets from the instance: the
# fixture's 2-6 tokens a news pad to 8 rather than the class's 64.
TOKEN_BUCKETS = (8,)
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


def _store(emb: np.ndarray, rng: np.random.Generator) -> list:
    """Each news item's 2-6 tokens: its embedding plus noise."""
    return [
        emb[i][None] + rng.standard_normal((int(rng.integers(2, 7)), D)).astype(np.float32) * 0.05
        for i in range(len(emb))
    ]


@pytest.fixture(scope="module")
def fixture():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=100, num_rows=160, dim=D, noise=0.05, seed=7)
    ct = compile_behaviors(imps[:120], hist[:120]).with_history_view()
    cv = compile_behaviors(imps[120:], hist[120:]).with_history_view()
    rng = np.random.default_rng(3)
    arrays_t = _store(align_embeddings(ct.news_ids, emb), rng)
    arrays_v = _store(align_embeddings(cv.news_ids, emb), rng)
    return dict(
        ct=ct, cv=cv, store_t=TokenStore.from_ragged(arrays_t), store_v=TokenStore.from_ragged(arrays_v),
        jct=jax_compile(imps[:120], hist[:120]).with_history_view(),
        jcv=jax_compile(imps[120:], hist[120:]).with_history_view(),
        jstore_t=JaxTokenStore.from_ragged(arrays_t), jstore_v=JaxTokenStore.from_ragged(arrays_v),
    )


def _modules(seed: int = 1, dropout: bool = False):
    params = convert.random_e2e_params(np.random.default_rng(seed), D, 1, TowerConfig(**TOWER))
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(D, 1), "tower": build_tower(TowerConfig(**TOWER))})
    model.load_state_dict(convert.e2e_state_dict_from_jax(params), strict=True)
    if not dropout:
        for layer in model["token_encoder"].encoder.layer:
            layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return model["token_encoder"], model["tower"], params


def _port(f, cfg: dict, dropout: bool = False, **kwargs) -> EndToEndTrainer:
    enc, tower, _ = _modules(dropout=dropout)
    kwargs.setdefault("compiled_val", f["cv"])
    kwargs.setdefault("val_token_store", f["store_v"])
    t = EndToEndTrainer(
        enc, tower, f["ct"], f["store_t"], cfg=TrainConfig(**cfg), buckets=BUCKETS, max_token_len=8,
        device="cpu", **kwargs,
    )
    t.TOKEN_BUCKETS = TOKEN_BUCKETS
    return t


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_e2e_trainer_matches_jax_epoch_by_epoch(fixture, loss):
    """Two epochs with the eval each epoch (margin: the bucketed eval from
    the streamed store; InfoNCE: the fused flat eval from the resident
    store), then the materialized embeddings of both splits."""
    f = fixture
    cfg = dict(TRAIN, loss=loss, num_neg_per_pos=3)
    fused = loss == "infonce"
    flags = dict(eval_each_epoch=True, flat_eval=fused, device_metrics=fused, device_store=fused)
    port = _port(f, cfg, **flags)
    _, _, params = _modules()
    enc = JaxTokenAttentionPool(hidden_size=D, num_layers=1)

    def enc_apply(p, s, m, deterministic=False, rngs=None):
        return enc.apply(p, s, m, deterministic=True)

    jt = JaxEndToEndTrainer(
        enc_apply, jax.tree.map(jnp.asarray, params["token_encoder"]),
        jax_build_tower(JaxTowerConfig(**TOWER)).apply, jax.tree.map(jnp.asarray, params["tower"]),
        f["jct"], f["jstore_t"], cfg=JaxTrainConfig(**cfg), buckets=BUCKETS, max_token_len=8,
        compiled_val=f["jcv"], val_token_store=f["jstore_v"], **flags,
    )
    jt.TOKEN_BUCKETS = TOKEN_BUCKETS
    assert port.device_store == jt.device_store == fused
    got, want = port.train(), jt.train()
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        for split in ("train", "val"):
            for k in METRICS:
                assert g[split][k] == pytest.approx(w[split][k], abs=2e-3), (g["epoch"], split, k)
    assert got[-1]["loss"] < got[0]["loss"]
    for store, jstore in ((None, None), (f["store_v"], f["jstore_v"])):
        emb = port.materialize_news_embeddings(batch_size=16, store=store)
        want = np.asarray(jt.materialize_news_embeddings(batch_size=16, store=jstore), np.float64)
        assert np.linalg.norm(emb - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_device_store_and_streamed_routes_are_identical(fixture, loss):
    """Dropout on (the encoder's layers at 0.1, one generator seeded from
    ``cfg.seed``): the resident store and the streamed one give the same
    losses, parameters and materialized embeddings, bit for bit."""
    f = fixture
    cfg = dict(TRAIN, loss=loss, num_neg_per_pos=3)
    runs = [_port(f, cfg, dropout=True, device_store=d) for d in (False, True)]
    assert [t.device_store for t in runs] == [False, True]
    assert runs[1]._dev_states.dtype == torch.float32 and runs[0]._dev_states is None
    assert runs[0].train() == runs[1].train()
    for a, b in zip(runs[0].model.state_dict().values(), runs[1].model.state_dict().values()):
        assert torch.equal(a, b)
    assert np.array_equal(runs[0].materialize_news_embeddings(), runs[1].materialize_news_embeddings())


def test_device_store_defaults_to_the_memory_model(fixture):
    """``device_store=None`` asks ``fits_device_token_store`` (16 GiB on the
    CPU): the fixture's store fits; a float16 store stays float16."""
    f = fixture
    assert _port(f, TRAIN).device_store
    half = TokenStore(f["store_t"].states.astype(np.float16), f["store_t"].offsets)
    enc, tower, _ = _modules()
    t = EndToEndTrainer(enc, tower, f["ct"], half, cfg=TrainConfig(**TRAIN), max_token_len=8, device="cpu")
    assert t.device_store and t._dev_states.dtype == torch.float16
    assert np.isfinite(t.train_one_epoch())


@pytest.mark.parametrize("sync", [1, 3])
def test_non_finite_loss_aborts(fixture, sync):
    f = fixture
    states = f["store_t"].states.copy()
    states[:] = np.nan
    bad = TokenStore(states, f["store_t"].offsets)
    enc, tower, _ = _modules()
    t = EndToEndTrainer(
        enc, tower, f["ct"], bad, cfg=TrainConfig(**TRAIN, loss_sync_every=sync), max_token_len=8, device="cpu"
    )
    with pytest.raises(FloatingPointError, match="NaN/Inf"):
        t.train_one_epoch()


@pytest.mark.parametrize("with_val", [False, True])
def test_epoch_checkpoints_and_remote_sync(fixture, tmp_path, with_val):
    """``Epoch_N`` every epoch (the model's ``state_dict``), the best one
    where a val split scores it, ``remote_sync`` with each path, the JSONL
    log."""
    f = fixture
    synced = []
    kwargs = dict(
        ckpt_dir=tmp_path / "ckpt", log_dir=tmp_path / "logs", exp_name="e2e", remote_sync=synced.append,
        eval_each_epoch=with_val,
    )
    if not with_val:
        kwargs.update(compiled_val=None, val_token_store=None)
    t = _port(f, TRAIN, **kwargs)
    history = t.train()
    assert synced == [tmp_path / "ckpt" / f"Epoch_{e}" for e in (1, 2)]
    saved = load_pytree(tmp_path / "ckpt" / "Epoch_2")
    assert all(torch.equal(saved[k], v) for k, v in t.model.state_dict().items())
    assert (t.best.best_path is not None) == with_val
    assert ("val" in history[0]) == with_val
    lines = (tmp_path / "logs" / "train_final_history_score.jsonl").read_text().splitlines()
    assert len(lines) == 2


def test_save_and_restore_resume_bit_for_bit(fixture, tmp_path):
    """Dropout on, InfoNCE, the streamed store: save after epoch 1, restore
    into a fresh trainer, and its epoch 2 equals an uninterrupted run's
    (history, parameters, optimizer, the dropout generator, the sampling
    stream), bit for bit on the CPU."""
    f = fixture
    cfg = dict(TRAIN, loss="infonce", num_neg_per_pos=3)

    def trainer():
        return _port(f, cfg, dropout=True, device_store=False, eval_each_epoch=True)

    whole = trainer()
    whole.train(2)
    first = trainer()
    first.train(1)
    first.save_training_state(tmp_path / "state")
    resumed = trainer()
    assert resumed.restore_training_state(tmp_path / "state") == 1
    resumed.train(1)
    assert resumed.history == whole.history
    for (name, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert resumed.rng.bit_generator.state == whole.rng.bit_generator.state


def test_run_config2_returns_finite_metrics():
    """Config[2] at d=16 from a store of 3 tokens a news, one epoch."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=60, num_rows=60, dim=16, noise=0.05)
    c = compile_behaviors(imps, hist)
    rng = np.random.default_rng(0)
    emb_a = align_embeddings(c.news_ids, emb)
    store = TokenStore.from_ragged([emb_a[i][None] + rng.standard_normal((3, 16)).astype(np.float32) * 0.05 for i in range(c.num_news)])
    got = run_config2(c, store, 16, train_cfg=TrainConfig(learning_rate=1e-4, num_epochs=1, batch_size=16), max_token_len=4, device="cpu")
    assert set(got) == {*METRICS, "num_samples"} and got["num_samples"] == 60
    assert all(np.isfinite(got[k]) and 0.0 <= got[k] <= 1.0 for k in METRICS)


def test_e2e_entry_points_raise_without_cuda(fixture):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    f = fixture
    enc, tower, _ = _modules()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EndToEndTrainer(enc, tower, f["ct"], f["store_t"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_config2(f["ct"], f["store_t"], D)
    with pytest.raises(ValueError, match="come together"):
        EndToEndTrainer(enc, tower, f["ct"], f["store_t"], compiled_val=f["cv"], device="cpu")
    with pytest.raises(ValueError, match="flat_eval"):
        EndToEndTrainer(enc, tower, f["ct"], f["store_t"], device_metrics=True, device="cpu")


BUDGETS = [6 * 1024**3, 80 * 10**9]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("dim,token_len", [(1024, 64), (64, 512), (16, 8)])
def test_e2e_memory_estimators_match_jax(budget, dim, token_len):
    for name in ("estimate_token_attention_batch", "estimate_e2e_unique_news"):
        got = getattr(memory, name)(dim, token_len, hbm_budget_bytes=budget)
        assert got == getattr(jax_memory, name)(dim, token_len, hbm_budget_bytes=budget), name
    assert memory.transformer_activation_bytes(dim, 8, 3072, 3, token_len, 2) == jax_memory.transformer_activation_bytes(
        dim, 8, 3072, 3, token_len, 2
    )
    for tokens in (1_000, 1_460_000, 40_000_000):
        for es in (2, 4):
            assert memory.fits_device_token_store(tokens, dim, es, hbm_budget_bytes=budget) == jax_memory.fits_device_token_store(
                tokens, dim, es, hbm_budget_bytes=budget
            )
