"""The port's other tower components against the JAX package's, from the
same starting weights, on ``tests/test_torch_pipeline_world.py``'s data:
``AttentionComponent`` over ``final_attention`` (the padded path),
``AttentionWeightComponent`` (a blend), ``AttentionReduceComponent`` (a
reducer), ``StoreTokenStatesComponent``, ``AttentionAttentionComponent``
and ``TokenEmbeddingsComponent``. Scores and metrics within 1e-5; the
end-to-end component's learned table within a norm-relative 1e-5, the
tolerance of ``tests/test_torch_e2e_trainer.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from news_recommendation_project_v2_tpu.cli import common as jax_common
from news_recommendation_project_v2_tpu.config import NewsDataset as JaxDataset
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.pipeline import components as jax_components
from news_recommendation_project_v2_torch.cli.common import build_context
from news_recommendation_project_v2_torch.config import NewsDataset, TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.models import convert
from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer
from news_recommendation_project_v2_torch.ops.encode import TokenStore
from news_recommendation_project_v2_torch.pipeline import (
    AttentionAttentionComponent,
    AttentionReduceComponent,
    AttentionWeightComponent,
    StoreTokenStatesComponent,
    TokenEmbeddingsComponent,
    TransformDataComponent,
)
from test_torch_pipeline_world import (  # noqa: F401  (fixtures)
    D,
    FINAL,
    LATENT,
    TOL,
    TRAIN,
    assert_history,
    assert_metrics,
    classified,
    check_attention_components,
    e2e_modules,
    encoders,
    jax_cfg,
    tower_params,
    world,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


def test_final_attention_tower_components_match_jax(classified):
    """``AttentionComponent`` and ``FinalAttentionComponent`` over the
    ``final_attention`` tower: the padded step and the bucketed eval."""
    check_attention_components(classified, "final_attention", "margin")


def test_attention_weight_component_matches_jax(classified):
    """The final_attention tower and the blend, from alpha = 0 in both."""
    (pt, pv), (jt, jv) = classified
    port = AttentionWeightComponent(tower_config=FINAL, cfg=TrainConfig(**TRAIN), device="cpu")
    assert port.transform(dict(pv))["scores"] is not None  # untrained: alpha 0.5
    port.train(pt, pv)
    jc = jax_components.AttentionWeightComponent(tower_config=jax_cfg(FINAL), cfg=JaxTrainConfig(**TRAIN))
    jc.params = tower_params(FINAL)
    jc.train(jt, jv)
    assert_history(port._trainer.history, jc._trainer.history)
    assert port._trainer._alpha() == pytest.approx(jc._trainer._alpha(), abs=TOL)
    got, want = port.transform(dict(pv)), jc.transform(dict(jv))
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
    assert_metrics(got["metrics"], want["metrics"])


def test_attention_reduce_component_matches_jax(classified, monkeypatch):
    """The latent tower and a reducer to 32, the reducer's weights drawn
    from ``cfg.seed + 2`` with numpy in the port and injected into the JAX
    component's init."""
    (pt, pv), (jt, jv) = classified
    port = AttentionReduceComponent(tower_config=LATENT, cfg=TrainConfig(**TRAIN), device="cpu", reduced_dim=D)
    port.train(pt, pv)
    reduce_params = jax.tree.map(
        jnp.asarray, convert.random_reducing_params(np.random.default_rng(TRAIN["seed"] + 2), D, D)
    )

    class Injected(jax_towers.ReducingModel):
        def init(self, *args, **kwargs):
            return reduce_params

    monkeypatch.setattr(jax_components, "ReducingModel", Injected)
    jc = jax_components.AttentionReduceComponent(tower_config=jax_cfg(LATENT), cfg=JaxTrainConfig(**TRAIN), reduced_dim=D)
    jc.params = tower_params(LATENT)
    jc.train(jt, jv)
    assert_history(port._trainer.history, jc._trainer.history)
    got, want = port.transform(dict(pv)), jc.transform(dict(jv))
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
    assert_metrics(got["metrics"], want["metrics"])


@pytest.fixture(scope="module")
def stores(world, tmp_path_factory):
    """``StoreTokenStatesComponent`` in both packages over the train
    split's with-history rows (the port's written to a store directory)."""
    enc, jenc, params = encoders()
    tok = HashTokenizer(vocab_size=120, max_length=16)
    db = tmp_path_factory.mktemp("store") / "tokens"
    port = StoreTokenStatesComponent(enc, tok, db_path=db, batch_size=8, device="cpu").transform(
        TransformDataComponent().transform(build_context(world["root"] / "port", NewsDataset.MINDsmall_train))
    )
    want = jax_components.StoreTokenStatesComponent(
        jax.jit(lambda p, i, m: jenc.apply(p, i, m, method="hidden_states")), params, tok, batch_size=8
    ).transform(
        jax_components.TransformDataComponent().transform(
            jax_common.build_context(world["root"] / "jax", JaxDataset.MINDsmall_train)
        )
    )
    return port, want, db


def test_store_token_states_component_matches_jax(stores):
    port, want, db = stores
    assert "news_text_dict" not in port
    store = port["token_store"]
    np.testing.assert_array_equal(store.offsets, want["token_store"].offsets)
    np.testing.assert_allclose(np.asarray(store.states), np.asarray(want["token_store"].states), atol=TOL)
    reopened = TokenStore.open_dir(db)
    np.testing.assert_array_equal(np.asarray(reopened.states), np.asarray(store.states))


def test_attention_attention_and_token_embeddings_components_match_jax(stores):
    """``AttentionAttentionComponent`` one epoch from the token store, then
    the learned table it writes; ``TokenEmbeddingsComponent`` from the
    trained token encoder gives the same table."""
    port_ctx, jax_ctx, _ = stores
    cfg = TowerConfig(kind="latent", reduced_dim=D, num_latents=8, latent_dim_head=16)
    model, params = e2e_modules(cfg)
    port = AttentionAttentionComponent(
        model["token_encoder"], model["tower"], cfg=TrainConfig(**TRAIN), max_token_len=16, device="cpu"
    )
    assert "news_embeddings" not in port.transform(dict(port_ctx))  # nothing before training
    port.train(port_ctx)
    jenc = JaxTokenAttentionPool(hidden_size=D, num_layers=1)
    jc = jax_components.AttentionAttentionComponent(
        lambda p, s, m, deterministic=False, rngs=None: jenc.apply(p, s, m, deterministic=True),
        params["token_encoder"], jax_build_tower(jax_cfg(cfg)).apply, params["tower"],
        cfg=JaxTrainConfig(**TRAIN), max_token_len=16,
    )
    jc.train(jax_ctx)
    assert port._trainer.history[0]["loss"] == pytest.approx(jc._trainer.history[0]["loss"], rel=TOL)
    got = port.transform(dict(port_ctx))["news_embeddings"]
    want = np.asarray(jc.transform(dict(jax_ctx))["news_embeddings"], np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL
    table = TokenEmbeddingsComponent(model["token_encoder"], batch_size=16, max_token_len=16, device="cpu").transform(
        dict(port_ctx)
    )["news_embeddings"]
    jtable = jax_components.TokenEmbeddingsComponent(
        lambda p, s, m, deterministic=True, rngs=None: jenc.apply(p, s, m, deterministic=True),
        jc._trainer.params["token_encoder"], batch_size=16, max_token_len=16,
    ).transform(dict(jax_ctx))["news_embeddings"]
    np.testing.assert_array_equal(table, got)
    np.testing.assert_allclose(table, np.asarray(jtable), atol=1e-4)
    assert np.linalg.norm(table - np.asarray(jtable)) / np.linalg.norm(np.asarray(jtable)) <= TOL
