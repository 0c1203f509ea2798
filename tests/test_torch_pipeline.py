"""The port's step pipeline (``pipeline/``) against the JAX package's, on
the CPU: the cache and its keys, ``check_req_keys``, the data components
(TransformData, Embeddings, SaveEmbedding, LoadEmbedding, Classification)
and the LoadEmbedding -> Classification -> Attention pipeline as a whole,
one epoch each; the data and the injected weights are
``tests/test_torch_pipeline_world.py``'s. Metrics, scores and tables within
1e-5."""

import jax
import numpy as np
import pytest

from news_recommendation_project_v2_tpu.cli import common as jax_common
from news_recommendation_project_v2_tpu.config import NewsDataset as JaxDataset
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.pipeline import components as jax_components
from news_recommendation_project_v2_tpu.pipeline import pipeline as jax_pipeline
from news_recommendation_project_v2_torch.cli.common import build_context
from news_recommendation_project_v2_torch.config import QUERY_INSTRUCTION, NewsDataset, TrainConfig
from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer
from news_recommendation_project_v2_torch.pipeline import (
    AttentionComponent,
    ClassificationComponent,
    EmbeddingsComponent,
    LoadEmbeddingComponent,
    Pipeline,
    PipelineComponent,
    SaveEmbeddingComponent,
    TransformDataComponent,
    check_req_keys,
)
from news_recommendation_project_v2_torch.pipeline.pipeline import fingerprint_context
from test_torch_pipeline_world import (  # noqa: F401  (fixtures)
    D,
    LATENT,
    SPLITS,
    TOL,
    TRAIN,
    JaxPerSplit,
    PerSplit,
    assert_metrics,
    classified,
    contexts,
    encoders,
    jax_cfg,
    jax_head,
    tower_params,
    world,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


# -- the pipeline kernel ---------------------------------------------------


class _Counting(PipelineComponent):
    required_keys = {"compiled"}

    def __init__(self, scale: float):
        self.scale = scale
        self.calls = 0

    def transform(self, context):
        self.calls += 1
        context["out"] = self.scale * context["compiled"].imp_lens.sum()
        return context


def test_cache_hits_and_misses(world, tmp_path):
    """A second run of the same steps over the same data loads every step
    from the cache; a changed component setting misses from its step on;
    a changed history string in the entry context misses everywhere."""
    def run(scale, ctx):
        counter = _Counting(scale)
        pipe = Pipeline("t", [("transform", TransformDataComponent()), ("count", counter)], cache_dir=tmp_path)
        out, _ = pipe.transform(ctx)
        return out, counter, [hit for _, _, hit in pipe.step_log]

    ctx = lambda: build_context(world["root"] / "port", NewsDataset.MINDsmall_train)  # noqa: E731
    first, counter, hits = run(2.0, ctx())
    assert hits == [False, False] and counter.calls == 1
    again, counter, hits = run(2.0, ctx())
    assert hits == [True, True] and counter.calls == 0 and again["out"] == first["out"]
    _, counter, hits = run(3.0, ctx())
    assert hits == [True, False] and counter.calls == 1
    changed = ctx()
    history = changed["behaviors"].history
    row = next(i for i, h in enumerate(history) if h is not None)
    history[row] = history[row].split()[0]
    _, counter, hits = run(2.0, changed)
    assert hits == [False, False] and counter.calls == 1


def test_fingerprint_hashes_every_value():
    base = {"a": ["N1 N2", None], "b": np.arange(4), "c": {"k": (1, "x")}}
    fp = fingerprint_context(base)
    assert fingerprint_context({**base}) == fp
    for changed in (
        {**base, "a": ["N1 N3", None]},
        {**base, "a": ["N1 N2", ""]},
        {**base, "b": np.arange(1, 5)},
        {**base, "c": {"k": (1, "y")}},
        {**base, "b": np.array(["a", None], dtype=object)},
    ):
        assert fingerprint_context(changed) != fp


def test_check_req_keys_matches_jax():
    check_req_keys({"a"}, {"a": 1, "b": 2})
    for check in (check_req_keys, jax_pipeline.check_req_keys):
        with pytest.raises(AssertionError, match="Required key 'c' is not present in context"):
            check({"c"}, {"a": 1})


def test_pipeline_checks_required_keys_before_running(tmp_path):
    with pytest.raises(AssertionError, match="'compiled'"):
        Pipeline("t", [("count", _Counting(1.0))], use_cache=False).transform({})


# -- the components --------------------------------------------------------


def test_transform_data_matches_jax(world):
    """The compiled arrays, the impression ids and the category and entity
    arrays aligned to the compiled news ids, equal."""
    got = TransformDataComponent().transform(build_context(world["root"] / "port", NewsDataset.MINDsmall_dev))
    want = jax_components.TransformDataComponent().transform(
        jax_common.build_context(world["root"] / "jax", JaxDataset.MINDsmall_dev)
    )
    assert "behaviors" not in got and "news_category" not in got
    for field in ("news_ids", "imp_rev", "imp_row", "imp_lens", "hist_rev", "hist_lens", "hist_row_index", "labels_flat"):
        np.testing.assert_array_equal(getattr(got["compiled"], field), getattr(want["compiled"], field), err_msg=field)
    for key in ("imp_ids", "news_category_ids", "news_subcategory_ids", "news_title_entity_vecs", "news_abstract_entity_vecs"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_embeddings_component_matches_jax(world):
    """Both tables of the news texts through the same encoder weights,
    bucketed at 16 and 32 tokens."""
    enc, jenc, params = encoders()
    tok = HashTokenizer(vocab_size=120, max_length=32)
    got = EmbeddingsComponent(enc, tok, QUERY_INSTRUCTION, batch_size=8, token_buckets=(16, 32), device="cpu").transform(
        TransformDataComponent().transform(build_context(world["root"] / "port", NewsDataset.MINDsmall_dev))
    )
    want = jax_components.EmbeddingsComponent(
        jax.jit(lambda p, i, m: jenc.apply(p, i, m)), params, tok, QUERY_INSTRUCTION, batch_size=8,
        token_buckets=(16, 32),
    ).transform(
        jax_components.TransformDataComponent().transform(
            jax_common.build_context(world["root"] / "jax", JaxDataset.MINDsmall_dev)
        )
    )
    for key in ("news_embeddings", "query_news_embeddings"):
        assert got[key].dtype == np.float32 and got[key].shape == (len(got["compiled"].news_ids), D)
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=TOL)


def test_save_and_load_embedding_components_match_jax(world, tmp_path):
    """The port's dump is the JAX package's: each package loads the
    other's, realigned to its compiled news ids."""
    port_dev, jax_dev = contexts(world, "port")[1], contexts(world, "jax")[1]
    rows = [int(n[1:]) for n in port_dev["compiled"].news_ids]
    np.testing.assert_array_equal(port_dev["news_embeddings"], world["emb"][rows])
    np.testing.assert_array_equal(port_dev["query_news_embeddings"], world["query"][rows])
    SaveEmbeddingComponent(tmp_path / "port", "dev").transform(port_dev)
    jax_components.SaveEmbeddingComponent(tmp_path / "jax", "dev").transform(jax_dev)
    for src in ("port", "jax"):
        for load, ctx in (
            (LoadEmbeddingComponent(tmp_path / src, "dev"), dict(port_dev)),
            (jax_components.LoadEmbeddingComponent(tmp_path / src, "dev"), dict(jax_dev)),
        ):
            out = load.transform(ctx)
            np.testing.assert_array_equal(out["news_embeddings"], port_dev["news_embeddings"])
            np.testing.assert_array_equal(out["query_news_embeddings"], port_dev["query_news_embeddings"])
    only = LoadEmbeddingComponent(tmp_path / "port", "dev", with_query=False).transform({"compiled": port_dev["compiled"]})
    assert "query_news_embeddings" not in only


def test_classification_component_matches_jax(classified):
    for got, want in zip(*classified):
        np.testing.assert_allclose(got["classification_preds"], np.asarray(want["classification_preds"]), atol=TOL)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
        assert_metrics(got["metrics"], want["metrics"])


# -- the slice as a whole ----------------------------------------------------


def test_load_classification_attention_pipeline_matches_jax(world, tmp_path, monkeypatch):
    """The train CLI's pipeline, one epoch each, trained on the train split
    with the dev split beside it, in both packages: the final train and
    dev metrics within 1e-5."""
    monkeypatch.chdir(tmp_path)

    def steps(pkg):
        if pkg == "port":
            return [
                ("init_transform", TransformDataComponent()),
                ("load", PerSplit(world["root"] / "emb")),
                ("classification", ClassificationComponent(cfg=TrainConfig(**TRAIN), device="cpu")),
                ("attention", AttentionComponent(tower_config=LATENT, cfg=TrainConfig(**TRAIN), device="cpu")),
            ]
        cls = jax_components.ClassificationComponent(cfg=JaxTrainConfig(**TRAIN))
        cls._head_and_params = jax_head(TRAIN["seed"])
        attn = jax_components.AttentionComponent(tower_config=jax_cfg(LATENT), cfg=JaxTrainConfig(**TRAIN))
        attn.params = tower_params(LATENT)
        return [
            ("init_transform", jax_components.TransformDataComponent()),
            ("load", JaxPerSplit(world["root"] / "emb")),
            ("classification", cls),
            ("attention", attn),
        ]

    got = Pipeline("port", steps("port"), use_cache=False).train(
        *(build_context(world["root"] / "port", NewsDataset[n]) for n in SPLITS)
    )
    want = jax_pipeline.Pipeline("jax", steps("jax"), use_cache=False).train(
        *(jax_common.build_context(world["root"] / "jax", JaxDataset[n]) for n in SPLITS)
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL)
        assert_metrics(g["metrics"], w["metrics"])
