"""Shared data, weights and checks of the port's pipeline tests against
the JAX package (``tests/test_torch_pipeline*.py``).

The data is the synthetic MIND fixture (60 news; 40 train and 40 dev rows)
ingested by each package, with numpy-drawn d=32 passage and query tables
keyed by news id, written as one dump a split with its rows shuffled. The
port draws its modules' weights with numpy from ``cfg.seed``
(``models.convert``); the JAX components get the same weights injected
(``params`` set, ``_head_and_params`` replaced, the reducer's and the
encoders' params given). Dropout is off where a component trains a module
that has it. Metrics, scores and tables within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.cli import common as jax_common
from news_recommendation_project_v2_tpu.cli.train import _PerSplitLoad as JaxPerSplit  # noqa: F401
from news_recommendation_project_v2_tpu.config import EncoderConfig as JaxEncoderConfig
from news_recommendation_project_v2_tpu.config import NewsDataset as JaxDataset
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.ingest import store_processed_data as jax_store
from news_recommendation_project_v2_tpu.data.synthetic import write_synthetic_mind as jax_write
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from news_recommendation_project_v2_tpu.pipeline import components as jax_components
from news_recommendation_project_v2_torch.cli.common import build_context
from news_recommendation_project_v2_torch.cli.train import _PerSplitLoad as PerSplit  # noqa: F401
from news_recommendation_project_v2_torch.config import EncoderConfig, NewsDataset, TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.ingest import store_processed_data
from news_recommendation_project_v2_torch.data.synthetic import write_synthetic_mind
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower, convert
from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder
from news_recommendation_project_v2_torch.ops.encode import save_embeddings
from news_recommendation_project_v2_torch.pipeline import (
    AttentionComponent,
    ClassificationComponent,
    FinalAttentionComponent,
    LoadEmbeddingComponent,
    TransformDataComponent,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
SPLITS = ("MINDsmall_train", "MINDsmall_dev")
LATENT = TowerConfig(kind="latent", embedding_dim=D, reduced_dim=D, hidden_dim=4 * D, num_latents=8, latent_dim_head=16)
FINAL = TowerConfig(kind="final_attention", embedding_dim=D, reduced_dim=D, hidden_dim=64, dropout_rate=0.0)
TRAIN = dict(learning_rate=3e-4, num_epochs=1, batch_size=32, seed=0)
TINY_ENCODER = dict(
    vocab_size=120, hidden_dim=D, num_layers=2, num_heads=4, intermediate_dim=64, max_position=34,
    compute_dtype="float32",
)
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")
TOL = 1e-5


def jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def unit(rng, n):
    e = rng.standard_normal((n, D)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' ingests of the fixture, their transformed contexts,
    and the id-keyed passage and query tables written as one dump a split
    (rows shuffled, so a load must realign them)."""
    root = tmp_path_factory.mktemp("pipeline")
    for name in SPLITS:
        write_synthetic_mind(root / "port", NewsDataset[name])
        jax_write(root / "jax", JaxDataset[name])
        store_processed_data(root / "port", NewsDataset[name])
        jax_store(root / "jax", JaxDataset[name])
    rng = np.random.default_rng(0)
    emb, query = unit(rng, 60), unit(rng, 60)
    ids = np.array([f"N{i}" for i in range(60)])
    perm = rng.permutation(60)
    for name in SPLITS:
        save_embeddings(root / "emb", name, emb[perm], query[perm], news_ids=ids[perm])
    return dict(root=root, emb=emb, query=query)


def contexts(world, package: str):
    """(train, dev) entry contexts of ``package``, transformed and with
    their dumps loaded (the LoadEmbedding step)."""
    out = []
    for name in SPLITS:
        if package == "port":
            ctx = build_context(world["root"] / "port", NewsDataset[name])
            ctx = LoadEmbeddingComponent(world["root"] / "emb", name).transform(TransformDataComponent().transform(ctx))
        else:
            ctx = jax_common.build_context(world["root"] / "jax", JaxDataset[name])
            ctx = jax_components.TransformDataComponent().transform(ctx)
            ctx = jax_components.LoadEmbeddingComponent(world["root"] / "emb", name).transform(ctx)
        out.append(ctx)
    return out


def assert_metrics(got: dict, want: dict, tol=TOL):
    assert got["num_samples"] == want["num_samples"]
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], abs=tol), k


def assert_history(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
        for split in ("train", "val"):
            if w.get(split) is not None:
                assert_metrics(g[split], w[split])

def encoders():
    params = convert.random_encoder_params(EncoderConfig(**TINY_ENCODER), 0)
    enc = NewsEncoder(EncoderConfig(**TINY_ENCODER)).eval()
    enc.load_state_dict(convert.encoder_state_dict_from_jax(params, EncoderConfig(**TINY_ENCODER)))
    return enc, JaxNewsEncoder(JaxEncoderConfig(**TINY_ENCODER)), jax.tree.map(jnp.asarray, params)


def jax_head(seed):
    def head_and_params(dim):
        params = convert.random_classification_head_params(np.random.default_rng(seed), dim, dim)
        return jax_towers.ClassificationHead(in_dim=dim, hidden_dim=dim), jax.tree.map(jnp.asarray, params)

    return head_and_params


def classification_run(world):
    """Both packages' classification step trained on the train split,
    then applied to both splits."""
    (pt, pv), (jt, jv) = contexts(world, "port"), contexts(world, "jax")
    port = ClassificationComponent(cfg=TrainConfig(**TRAIN), device="cpu")
    port.train(pt, pv)
    jc = jax_components.ClassificationComponent(cfg=JaxTrainConfig(**TRAIN))
    jc._head_and_params = jax_head(TRAIN["seed"])
    jc.train(jt, jv)
    return (port.transform(pt), port.transform(pv)), (jc.transform(jt), jc.transform(jv))


@pytest.fixture(scope="module")
def classified(world):
    return classification_run(world)


def tower_params(cfg: TowerConfig):
    return jax.tree.map(jnp.asarray, convert.random_tower_params(np.random.default_rng(TRAIN["seed"]), cfg))


def e2e_modules(cfg: TowerConfig):
    params = convert.random_e2e_params(np.random.default_rng(1), D, 1, cfg)
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(D, 1), "tower": build_tower(cfg)})
    model.load_state_dict(convert.e2e_state_dict_from_jax(params))
    for layer in model["token_encoder"].encoder.layer:
        layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return model, jax.tree.map(jnp.asarray, params)


def check_attention_components(classified, kind, loss):
    """``AttentionComponent`` trained on the train split with the dev split
    for its epoch eval (the query tables read by both), then its scores
    over the classification baseline, and ``FinalAttentionComponent`` from
    the trained tower."""
    cfg, (pt, pv), (jt, jv) = LATENT if kind == "latent" else FINAL, *classified
    train = dict(TRAIN, loss=loss)
    port = AttentionComponent(tower_config=cfg, cfg=TrainConfig(**train), device="cpu")
    port.train(pt, pv)
    jc = jax_components.AttentionComponent(tower_config=jax_cfg(cfg), cfg=JaxTrainConfig(**train))
    jc.params = tower_params(cfg)
    jc.train(jt, jv)
    for got, want in ((port.transform(dict(pv)), jc.transform(dict(jv))), (port.transform(dict(pt)), jc.transform(dict(jt)))):
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
        assert_metrics(got["metrics"], want["metrics"])
    final = FinalAttentionComponent(tower_config=cfg, device="cpu")
    final.tower, final.initialised = port.tower, True
    jfinal = jax_components.FinalAttentionComponent(tower_config=jax_cfg(cfg))
    jfinal.params = jc.params
    assert_metrics(final.transform(dict(pv))["metrics"], jfinal.transform(dict(jv))["metrics"])
