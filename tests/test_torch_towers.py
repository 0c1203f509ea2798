"""The port's padded towers and small models (``models.attention``,
``models.towers``, ``models.pooling``, ``build_tower``) against the JAX
package's flax modules, on numpy-seeded weights and inputs, on the CPU.

Weights are drawn in the JAX layout (``models.convert.random_*_params``),
loaded into the port through its inverse converters, and handed to flax
through the JAX package's own converters (``convert_towers``) from the
port's ``state_dict``; each round trip is exact. Both compute in float32 and
sum in other orders: outputs within 1e-5. bfloat16 compute rounds at other
places in the two frameworks: a norm-relative 3e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.models import attention as jax_attention
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import convert_towers as jcv
from news_recommendation_project_v2_tpu.models import pooling as jax_pooling
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.models import attention, build_tower, convert, pooling, towers
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D, HIDDEN = 64, 128
CFGS = {
    "final_attention": TowerConfig(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=HIDDEN, dropout_rate=0.0),
    "transformer": TowerConfig(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=2, dropout_rate=0.0),
    "transformer_as_built": TowerConfig(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=1, as_built=True, dropout_rate=0.0),
}
JAX_CONVERT = {
    "final_attention": jcv.convert_final_attention,
    "transformer": lambda sd: jcv.convert_transformer_tower(sd, num_layers=2),
    "transformer_as_built": lambda sd: jcv.convert_transformer_tower(sd, num_layers=1),
}


def _history(rng, b=5, l=11, d=D):
    """MIND-like masks: right-padded rows of various lengths, one all pad;
    pad positions hold zero rows, as the gathers build them."""
    emb = rng.standard_normal((b, l, d)).astype(np.float32)
    lens = rng.integers(1, l + 1, b)
    lens[2] = 0
    mask = (np.arange(l)[None] < lens[:, None]).astype(np.float32)
    return emb * mask[..., None], mask


def _jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.shape(x) == np.shape(y) and np.array_equal(x, y)


def _port_tower(name, rng):
    cfg = CFGS[name]
    params = convert.random_tower_params(rng, cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.tower_state_dict_from_jax(cfg.kind, params), strict=True)
    return cfg, params, tower


@pytest.mark.parametrize("name", list(CFGS))
def test_tower_matches_flax_and_round_trips(rng, name):
    """``build_tower`` against the JAX package's ``build_tower`` on one
    batch with an all-pad row (finite in both), and the exact round trip
    port -> ``convert_*`` -> port."""
    cfg, params, tower = _port_tower(name, rng)
    jparams = JAX_CONVERT[name](tower.state_dict())
    _same_tree(jparams, params)
    emb, mask = _history(rng)
    with torch.no_grad():
        got = tower(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(jax_build_tower(_jax_cfg(cfg)).apply)(jparams, emb, mask))
    assert got.shape == want.shape == (5, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    back = convert.tower_state_dict_from_jax(cfg.kind, jax.tree.map(np.asarray, jparams))
    assert back.keys() == tower.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in tower.state_dict().items())


@pytest.mark.parametrize("name", ["final_attention", "transformer"])
def test_tower_bf16_compute(rng, name):
    """bfloat16 matmuls (float32 softmax, LayerNorms and readout) within a
    norm-relative 3e-2 of the JAX package's bfloat16 tower, and of the
    port's own float32."""
    cfg = dataclasses.replace(CFGS[name], compute_dtype="bfloat16")
    _, params, tower = _port_tower(name, rng)
    bf16 = build_tower(cfg)
    bf16.load_state_dict(tower.state_dict())
    emb, mask = _history(rng)
    with torch.no_grad():
        got = bf16(torch.from_numpy(emb), torch.from_numpy(mask)).float().numpy()
        f32 = tower(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_build_tower(_jax_cfg(cfg)).apply(params, emb, mask), np.float32)
    assert np.isfinite(got).all()
    for ref in (want, f32):
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 3e-2


def test_self_attention_masks_additively(rng):
    """``SelfAttention`` within 1e-5 of flax's, a fully masked row included:
    there the additive float32 bias gives a uniform softmax, finite."""
    sa = attention.SelfAttention(D)
    w = convert._Draw(rng)
    p = {"qkv_proj": w.dense(D, 3 * D), "o_proj": w.dense(D, D)}
    sd = {}
    for name in p:
        convert._put_dense(sd, name, p[name])
    sa.load_state_dict(sd, strict=True)
    emb, mask = _history(rng)
    with torch.no_grad():
        got = sa(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_attention.SelfAttention(D).apply({"params": p}, emb, mask))
    assert np.isfinite(got[2]).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gated_mlp_uses_tanh_gelu(rng):
    """``GatedMLP`` (intermediate 3,072 at any width, tanh GELU) within 1e-5
    of flax's; the exact GELU would not be."""
    mlp = attention.GatedMLP(D, dropout_rate=0.0)
    w = convert._Draw(rng)
    p = {"up_gate_proj": w.dense(D, 2 * 3072, bias=False), "down_proj": w.dense(3072, D)}
    sd = {}
    for name in p:
        convert._put_dense(sd, name, p[name])
    mlp.load_state_dict(sd, strict=True)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_attention.GatedMLP(D, dropout_rate=0.0).apply({"params": p}, x))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert attention.INTERMEDIATE_SIZE == jax_attention.GatedMLP.intermediate_size


@pytest.mark.parametrize("as_built", [False, True], ids=["post_norm", "as_built"])
def test_transformer_layer_and_token_pool(rng, as_built):
    """``TransformerLayer`` and ``TokenAttentionPool`` (the encoder, then
    the last real token) within 1e-5 of flax's; with ``as_built`` the layer
    is ``g_mlp_layernorm(input)``."""
    params = convert.random_token_attention_pool_params(rng, D, 1)
    pool = attention.TokenAttentionPool(D, 1, as_built=as_built)
    pool.load_state_dict(convert.token_attention_pool_state_dict_from_jax(params), strict=True)
    _same_tree(jcv.convert_token_attention_pool(pool.state_dict(), num_layers=1), params)
    emb, mask = _history(rng)
    layer = attention.TransformerLayer(D, dropout_rate=0.0, as_built=as_built)
    layer.load_state_dict({k[len("encoder.layer.0."):]: v for k, v in pool.state_dict().items()})
    with torch.no_grad():
        got_layer = layer(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
        got_pool = pool(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    jlayer = jax_attention.TransformerLayer(D, dropout_rate=0.0, as_built=as_built)
    want_layer = jlayer.apply({"params": params["params"]["encoder"]["layer_0"]}, emb, mask)
    want_pool = jax_attention.TokenAttentionPool(D, 1, as_built=as_built).apply(params, emb, mask)
    np.testing.assert_allclose(got_layer, np.asarray(want_layer), atol=1e-5)
    np.testing.assert_allclose(got_pool, np.asarray(want_pool), atol=1e-5)
    if as_built:
        ln = params["params"]["encoder"]["layer_0"]["g_mlp_layernorm"]
        x = emb.astype(np.float64)
        mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
        np.testing.assert_allclose(got_layer, (x - mu) / np.sqrt(var + 1e-12) * ln["scale"] + ln["bias"], atol=1e-5)


@pytest.mark.parametrize("left", [False, True], ids=["right_padded", "left_padded"])
def test_pooling_matches_jax(rng, left):
    """``last_token_pool`` (left and right padding, an all-pad row),
    ``first_token_pool``, ``average_pool`` and the architecture dispatch."""
    hidden = rng.standard_normal((4, 6, 5)).astype(np.float32)
    lens = np.array([6, 3, 1, 0]) if not left else np.array([6, 3, 1, 2])
    mask = (np.arange(6)[None] < lens[:, None]).astype(np.float32)
    if left:
        mask = mask[:, ::-1].copy()
    for name in ("last", "first", "mean"):
        got = pooling.POOLING[name](torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_pooling.POOLING[name](jnp.asarray(hidden), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    for arch in ("Qwen2ForCausalLM", "NewModel", "XLMRobertaModel", "BertModel"):
        got_fn, want_fn = pooling.pooling_for_architecture(arch), jax_pooling.pooling_for_architecture(arch)
        assert got_fn.__name__ == want_fn.__name__


def _small_models(rng):
    """Each ``towers.py`` class with its params in the JAX layout, the port
    module, the flax module, the JAX converter and the port's inverse, and
    one input."""
    w = convert._Draw(rng)
    x = rng.standard_normal((6, D)).astype(np.float32)
    cat_x = x.copy()
    cat_x[:, -1] = rng.integers(0, 15, 6)
    wrap_x = rng.standard_normal((6, D + 2)).astype(np.float32)
    wrap_x[:, -2] = rng.integers(0, 15, 6)
    wrap_x[:, -1] = rng.integers(0, 134, 6)
    head = convert.random_classification_head_params(rng, D, D)
    cat_head = convert.random_classification_head_params(rng, D - 1 + 128, D)
    cat_head["params"]["cat_embed"] = {"embedding": w.normal(15, 128)}
    wrap = {"params": {
        "cat_embed": {"embedding": w.normal(15, 16)},
        "subcat_embed": {"embedding": w.normal(134, 16)},
        "wrapped": convert.random_classification_head_params(rng, D + 32, D)["params"],
    }}
    resize = {"params": {
        "bottleneck_in": w.dense(D, 32), "bottleneck_out": w.dense(32, D),
        "wrapped": convert.random_reducing_params(rng, 32, 32)["params"],
    }}
    emb, mask = _history(rng)
    return {
        "classification_head": (head, towers.ClassificationHead(D, D), jax_towers.ClassificationHead(D, D),
                                jcv.convert_classification_head, convert.classification_head_state_dict_from_jax, (x,)),
        "classification_head_cat_embed": (
            cat_head, towers.ClassificationHeadCatEmbed(D - 1 + 128, D), jax_towers.ClassificationHeadCatEmbed(D - 1 + 128, D),
            jcv.convert_classification_head_cat_embed, convert.classification_head_cat_embed_state_dict_from_jax, (cat_x,)),
        "final_attention": (convert.random_final_attention_params(rng, CFGS["final_attention"]),
                            towers.FinalAttention(D, HIDDEN, 0.0), jax_towers.FinalAttention(D, HIDDEN, 0.0),
                            jcv.convert_final_attention, convert.final_attention_state_dict_from_jax, (emb, mask)),
        "weighted_sum": (convert.random_weighted_sum_params(rng), towers.WeightedSumModel(), jax_towers.WeightedSumModel(),
                         jcv.convert_weighted_sum, convert.weighted_sum_state_dict_from_jax, (x[:, 0], x[:, 1])),
        "reducing": (convert.random_reducing_params(rng, D, 32), towers.ReducingModel(D, 32), jax_towers.ReducingModel(D, 32),
                     jcv.convert_reducing_model, convert.reducing_state_dict_from_jax, (x,)),
        "embedding_wrapper": (
            wrap, towers.EmbeddingWrapper(towers.ClassificationHead(D + 32, D), cat_dim=16),
            jax_towers.EmbeddingWrapper(wrapped=jax_towers.ClassificationHead(D + 32, D), cat_dim=16),
            lambda sd: jcv.convert_embedding_wrapper(sd, jcv.convert_classification_head),
            lambda p: convert.embedding_wrapper_state_dict_from_jax(p, convert.classification_head_state_dict_from_jax),
            (wrap_x,)),
        "resize_wrapper": (
            resize, towers.ResizeWrapperModel(towers.ReducingModel(32, 32), D, 32),
            jax_towers.ResizeWrapperModel(wrapped=jax_towers.ReducingModel(32, 32), embed_dim=D, reduced_dim=32),
            lambda sd: jcv.convert_resize_wrapper(sd, jcv.convert_reducing_model),
            lambda p: convert.resize_wrapper_state_dict_from_jax(p, convert.reducing_state_dict_from_jax),
            (x,)),
    }


@pytest.mark.parametrize("name", [
    "classification_head", "classification_head_cat_embed", "final_attention", "weighted_sum",
    "reducing", "embedding_wrapper", "resize_wrapper",
])
def test_small_models_match_flax_and_round_trip(rng, name):
    """Each of the seven ``towers.py`` classes within 1e-5 of its flax module,
    the weights through the JAX converter from the port's ``state_dict``,
    and the round trip exact."""
    params, port, flax_module, to_jax, from_jax, args = _small_models(rng)[name]
    port.load_state_dict(from_jax(params), strict=True)
    jparams = to_jax(port.state_dict())
    _same_tree(jparams, params)
    back = from_jax(jax.tree.map(np.asarray, jparams))
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items()) and back.keys() == port.state_dict().keys()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(flax_module.apply(jparams, *args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_build_tower_kinds_and_dropout():
    """``build_tower`` builds every kind; dropout runs only with a
    generator, and two generators of one seed draw the same masks."""
    for kind in ("latent", "final_attention", "transformer"):
        assert build_tower(TowerConfig(kind=kind, reduced_dim=D, num_latents=8, latent_dim_head=16, hidden_dim=HIDDEN))
    with pytest.raises(ValueError, match="Unknown tower kind"):
        build_tower(TowerConfig(kind="nope"))
    tower = build_tower(dataclasses.replace(CFGS["transformer"], dropout_rate=0.5))
    emb, mask = (torch.from_numpy(a) for a in _history(np.random.default_rng(1)))
    with torch.no_grad():
        plain = tower(emb, mask)
        a = tower(emb, mask, generator=torch.Generator().manual_seed(3))
        b = tower(emb, mask, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert torch.equal(plain, tower(emb, mask).detach())
