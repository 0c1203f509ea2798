"""The port's news encoder in its decoder layout (Qwen2, Mistral, Llama) and
NV-Embed's (bidirectional, with the latent-attention pooling head) against
the JAX package's on the same numpy-seeded weights, on the CPU: float32
within 1e-5 under grouped-query attention (the head through the port's
plain kernel versions); the NV-Embed layout's conversion and its loud
errors, word for word the JAX package's; bfloat16 rows that are all pad
stay finite."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import EncoderConfig as JaxEncoderConfig
from news_recommendation_project_v2_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from news_recommendation_project_v2_tpu.models.news_encoder import convert_hf_state_dict
from news_recommendation_project_v2_torch.models.convert import (
    encoder_state_dict_from_hf,
    encoder_state_dict_from_jax,
    random_encoder_params,
)
from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder, encoder_config_from_hf
from news_recommendation_project_v2_torch.ops.geglu import geglu
from news_recommendation_project_v2_torch.ops.latent_attention import latent_attention
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


def _jax_config(cfg):
    """The JAX package's config of the port's ``cfg``: its own fields (the
    port's DeepSeek-V3 fields have no counterpart there)."""
    return JaxEncoderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxEncoderConfig)})

# A tiny Mistral-shaped backbone: 4 query heads over 2 kv heads (GQA).
TEXT = dict(
    vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=64, rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=64,
)
HF = {
    "qwen2": dict(TEXT, architectures=["Qwen2Model"]),
    "mistral": dict(TEXT, architectures=["MistralForCausalLM"]),
    "llama": dict(TEXT, architectures=["LlamaModel"]),
    "nv_embed": dict(
        architectures=["NVEmbedModel"], text_config=TEXT,
        latent_attention_config=dict(num_latents_value=6, num_cross_heads=2, cross_dim_head=8, latent_dim=32),
    ),
}


def _config(name, **kw):
    return encoder_config_from_hf(HF[name], compute_dtype="float32", **kw)


def _ids(b=4, t=9):
    """Right-padded ids with 9, 6, 2 and 0 real tokens (an all-pad row)."""
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 97, (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate((9, 6, 2, 0)[:b]):
        mask[i, :n] = 1
    return ids, mask


def _port(cfg, params):
    enc = NewsEncoder(cfg)
    enc.load_state_dict(encoder_state_dict_from_jax(params, cfg))
    return enc


def _both(enc, cfg, params, ids, mask, method):
    with torch.no_grad():
        got = getattr(enc, method)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    jmethod = "__call__" if method == "forward" else method
    want = JaxNewsEncoder(_jax_config(cfg)).apply(
        jax_params, jnp.asarray(ids), jnp.asarray(mask), method=jmethod
    )
    return got, np.asarray(want)


@pytest.mark.parametrize("name", ["qwen2", "mistral", "llama"])
def test_decoder_matches_jax(name):
    """Causal, GQA, q/k/v biased for Qwen2 only: hidden states and the
    last-token vectors within 1e-5."""
    cfg = _config(name)
    assert cfg.arch == "qwen2" and cfg.num_kv_heads == 2 and cfg.qkv_bias == (name == "qwen2")
    assert cfg.pooling == "last" and not cfg.bidirectional
    params = random_encoder_params(cfg, 0)
    enc = _port(cfg, params)
    ids, mask = _ids(b=3)
    for method in ("hidden_states", "forward"):
        got, want = _both(enc, cfg, params, ids, mask, method)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nv_embed_matches_jax():
    """Bidirectional attention and the latent-pool head (6 latents, 2 heads x
    8) through the port's wrappers, which take their plain versions on CPU
    tensors and launch nothing; an all-pad row included. Within 1e-5."""
    cfg = _config("nv_embed")
    assert cfg.bidirectional and cfg.latent_pool and (cfg.latent_pool_num_latents, cfg.latent_pool_heads) == (6, 2)
    params = random_encoder_params(cfg, 0)
    enc = _port(cfg, params)
    ids, mask = _ids()
    launches = latent_attention.launches, geglu.launches
    for method in ("hidden_states", "forward"):
        got, want = _both(enc, cfg, params, ids, mask, method)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (latent_attention.launches, geglu.launches) == launches


def test_bidirectional_sees_later_tokens():
    """Causal: a token's state ignores every later token; bidirectional
    (NV-Embed): it does not."""
    ids, mask = _ids(b=1)
    later = ids.copy()
    later[0, 5] = 7 if ids[0, 5] != 7 else 8
    for name, moves in (("mistral", False), ("nv_embed", True)):
        cfg = _config(name)
        enc = _port(cfg, random_encoder_params(cfg, 0))
        with torch.no_grad():
            a, b = (enc.hidden_states(torch.from_numpy(x), torch.from_numpy(mask))[0, :5] for x in (ids, later))
        assert (not torch.allclose(a, b, rtol=0, atol=1e-4)) == moves, name


def _nv_layout(sd: dict) -> dict:
    """The port's NV-Embed state_dict in the checkpoint's layout: the backbone
    under ``embedding_model.``, the head under ``latent_attention_model.``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("latent_pool."):
            out["latent_attention_model." + k[len("latent_pool."):]] = v.numpy()
        else:
            out["embedding_model." + k] = v.numpy()
    return out


def test_nv_embed_conversion_round_trip_is_exact():
    """flax params -> the port's state_dict -> the NV-Embed checkpoint layout
    -> the JAX package's ``convert_hf_state_dict`` -> the same flax params to
    the bit; the port's own HF normalisation loads the same layout back."""
    cfg = _config("nv_embed")
    params = random_encoder_params(cfg, 2)
    sd = encoder_state_dict_from_jax(params, cfg)
    nv = _nv_layout(sd)
    back = convert_hf_state_dict(nv, _jax_config(cfg))
    leaves_a = jax.tree_util.tree_leaves_with_path(params)
    leaves_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_b]
    for (path, a), (_, b) in zip(leaves_a, leaves_b):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    normalised = encoder_state_dict_from_hf(nv, cfg)
    assert normalised.keys() == sd.keys() and all(torch.equal(normalised[k], sd[k]) for k in sd)


@pytest.mark.parametrize("bias", [True, False])
def test_qwen2_round_trip_with_and_without_bias(bias):
    """``model.``-prefixed causal-LM keys and an ``lm_head``, q/k/v biased or
    not: the JAX converter recovers the params exactly, the port's
    normalisation strips the prefix and drops the head."""
    cfg = _config("qwen2", qkv_bias=bias)
    params = random_encoder_params(cfg, 4)
    sd = encoder_state_dict_from_jax(params, cfg)
    hf = {f"model.{k}": v.numpy() for k, v in sd.items()}
    hf["lm_head.weight"] = np.zeros((97, 32), np.float32)
    back = convert_hf_state_dict(hf, _jax_config(cfg))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    normalised = encoder_state_dict_from_hf(hf, cfg)
    assert normalised.keys() == sd.keys()
    NewsEncoder(cfg).load_state_dict(normalised)


def _errors():
    nv_cfg = _config("nv_embed")
    nv = _nv_layout(encoder_state_dict_from_jax(random_encoder_params(nv_cfg, 0), nv_cfg))
    plain_cfg = _config("mistral")
    plain = {k: v.numpy() for k, v in encoder_state_dict_from_jax(random_encoder_params(plain_cfg, 0), plain_cfg).items()}
    no_head = {k: v for k, v in nv.items() if k.startswith("embedding_model.")}
    return {
        "head_without_latent_pool": (nv, plain_cfg),
        "latent_pool_without_head": (plain, nv_cfg),
        "nv_layout_without_head": (no_head, nv_cfg),
        "bias_mismatch": (plain, _config("mistral", qkv_bias=True)),
    }


@pytest.mark.parametrize("case", ["head_without_latent_pool", "latent_pool_without_head", "nv_layout_without_head", "bias_mismatch"])
def test_layout_errors_match_jax(case):
    state, cfg = _errors()[case]
    with pytest.raises(ValueError) as want:
        convert_hf_state_dict(state, _jax_config(cfg))
    with pytest.raises(ValueError) as got:
        encoder_state_dict_from_hf(state, cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["mistral", "nv_embed"])
def test_bfloat16_all_pad_rows_stay_finite(name):
    """The masks sit at bfloat16's finite min, so a row with no real token
    softmaxes to a uniform row, not NaN; the other rows stay within a
    norm-relative 3e-2 of float32."""
    cfg32 = _config(name)
    params = random_encoder_params(cfg32, 0)
    ids, mask = _ids()
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = encoder_config_from_hf(HF[name], compute_dtype=dtype)
        with torch.no_grad():
            out[dtype] = _port(cfg, params)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(out["bfloat16"]).all()
    real = mask.sum(1) > 0
    rel = np.linalg.norm(out["bfloat16"][real] - out["float32"][real]) / np.linalg.norm(out["float32"][real])
    assert rel <= 3e-2
