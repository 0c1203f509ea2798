"""The port's news encoder in its BERT/XLM-R layout (``models.news_encoder``)
against the JAX package's on the same numpy-seeded weights, on the CPU:
hidden states and pooled vectors within 1e-5 in float32 (both sum in
float32, in other orders) and a norm-relative 3e-2 in bfloat16 (the JAX
package rounds its softmax to bfloat16, the port keeps it float32);
padding invariance; RoBERTa positions; first and mean pooling; the weight
converters' exact round trip; ``HashTokenizer``; and
``encoder_config_from_hf``'s configs and errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import EncoderConfig as JaxEncoderConfig
from news_recommendation_project_v2_tpu.models.news_encoder import HashTokenizer as JaxHashTokenizer
from news_recommendation_project_v2_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from news_recommendation_project_v2_tpu.models.news_encoder import convert_hf_state_dict
from news_recommendation_project_v2_tpu.models.news_encoder import encoder_config_from_hf as jax_config_from_hf
from news_recommendation_project_v2_torch.config import EncoderConfig
from news_recommendation_project_v2_torch.models.convert import (
    encoder_state_dict_from_hf,
    encoder_state_dict_from_jax,
    random_encoder_params,
)
from news_recommendation_project_v2_torch.models.news_encoder import (
    HashTokenizer,
    NewsEncoder,
    encoder_config_from_hf,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

TINY = dict(vocab_size=97, hidden_dim=32, num_layers=2, num_heads=4, intermediate_dim=64, max_position=20)


def _ids(seed=1, b=4, t=9):
    """Right-padded ids with 9, 6, 2 and 1 real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate((9, 6, 2, 1)[:b]):
        mask[i, :n] = 1
    ids[mask == 0] = 1
    return ids, mask


def _pair(**kw):
    cfg = EncoderConfig(**{**TINY, **kw})
    params = random_encoder_params(cfg, 0)
    enc = NewsEncoder(cfg)
    enc.load_state_dict(encoder_state_dict_from_jax(params, cfg))
    return enc, JaxNewsEncoder(JaxEncoderConfig(**{**TINY, **kw})), jax.tree_util.tree_map(jnp.asarray, params)


def _port(enc, ids, mask, method="forward"):
    with torch.no_grad():
        return getattr(enc, method)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def _jax(enc, params, ids, mask, method="__call__"):
    return np.asarray(enc.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=method))


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("pooling", ["mean", "first"])
def test_float32_matches_jax(pooling):
    """Hidden states and pooled, normalised vectors within 1e-5; the pooled
    vectors of unit norm."""
    enc, jenc, params = _pair(pooling=pooling, compute_dtype="float32")
    ids, mask = _ids()
    hidden = _port(enc, ids, mask, "hidden_states")
    assert hidden.dtype == np.float32 and hidden.shape == (4, 9, 32)
    np.testing.assert_allclose(hidden, _jax(jenc, params, ids, mask, "hidden_states"), rtol=0, atol=1e-5)
    pooled = _port(enc, ids, mask)
    np.testing.assert_allclose(pooled, _jax(jenc, params, ids, mask), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(pooled, axis=-1), 1.0, atol=1e-5)


def test_bfloat16_matches_jax():
    """The default compute type: within a norm-relative 3e-2 of the JAX
    package in bfloat16, and finite."""
    enc, jenc, params = _pair()
    assert enc.compute_dtype == torch.bfloat16
    ids, mask = _ids()
    for method, jmethod in (("hidden_states", "hidden_states"), ("forward", "__call__")):
        got = _port(enc, ids, mask, method)
        assert np.isfinite(got).all()
        assert _norm_rel(got, _jax(jenc, params, ids, mask, jmethod)) <= 3e-2


def test_padding_does_not_change_real_tokens():
    """A row's real tokens' states and its pooled vector do not depend on
    how far it is padded, nor on the ids under its pad."""
    enc, _, _ = _pair(compute_dtype="float32")
    ids, mask = _ids()
    wide_ids = np.pad(ids, ((0, 0), (0, 7)), constant_values=5)
    wide_mask = np.pad(mask, ((0, 0), (0, 7)))
    h, hw = _port(enc, ids, mask, "hidden_states"), _port(enc, wide_ids, wide_mask, "hidden_states")
    for i, n in enumerate(mask.sum(1)):
        np.testing.assert_allclose(hw[i, :n], h[i, :n], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_port(enc, wide_ids, wide_mask), _port(enc, ids, mask), rtol=0, atol=1e-5)


def test_roberta_positions():
    """Real tokens take positions 2, 3, ... and pads position 1: changing
    position row 1 moves no real token's state, changing row 2 moves them."""
    enc, _, _ = _pair(compute_dtype="float32")
    ids, mask = _ids()
    base = _port(enc, ids, mask, "hidden_states")
    table = enc.embeddings["position_embeddings"].weight
    for row, moves in ((1, False), (0, False), (2, True)):
        with torch.no_grad():
            saved = table[row].clone()
            table[row] += torch.linspace(-1.0, 1.0, table.shape[1])
            got = _port(enc, ids, mask, "hidden_states")
            table[row] = saved
        real = mask.astype(bool)
        assert (np.abs(got[real] - base[real]).max() > 1e-3) == moves, row


def test_converter_round_trip_is_exact():
    """flax params -> the port's state_dict -> the JAX package's
    ``convert_hf_state_dict`` (the HF direction) -> the same flax params, to
    the bit; and the port's own HF normalisation strips ``roberta.`` and
    drops the pooler and position-id buffer, and loads."""
    cfg = EncoderConfig(**TINY)
    params = random_encoder_params(cfg, 3)
    sd = encoder_state_dict_from_jax(params, cfg)
    hf = {f"roberta.{k}": v.numpy() for k, v in sd.items()}
    hf["roberta.pooler.dense.weight"] = np.zeros((32, 32), np.float32)
    hf["roberta.embeddings.position_ids"] = np.arange(20)[None]
    back = convert_hf_state_dict(hf, JaxEncoderConfig(**TINY))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    normalised = encoder_state_dict_from_hf(hf, cfg)
    assert normalised.keys() == sd.keys()
    NewsEncoder(cfg).load_state_dict(normalised)
    assert all(torch.equal(normalised[k], sd[k]) for k in sd)


@pytest.mark.parametrize("max_length", [None, 5])
def test_hash_tokenizer_matches_jax(max_length):
    texts = ["Title: Stocks rally as markets rebound", "", "one", "A B c d e f g h i j k"]
    got = HashTokenizer(vocab_size=5003, max_length=12)(texts, max_length)
    want = JaxHashTokenizer(vocab_size=5003, max_length=12)(texts, max_length)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


MISTRAL = dict(
    architectures=["MistralModel"], vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336, rms_norm_eps=1e-5,
    rope_theta=10000.0, sliding_window=4096, max_position_embeddings=32768,
)
HF_CONFIGS = {
    "xlmr": dict(architectures=["XLMRobertaModel"], vocab_size=250002, hidden_size=1024, num_hidden_layers=24,
                 num_attention_heads=16, intermediate_size=4096, max_position_embeddings=514, layer_norm_eps=1e-5),
    "bert": dict(architectures=["BertModel"], vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512, layer_norm_eps=1e-12),
    "qwen2": dict(architectures=["Qwen2ForCausalLM"], vocab_size=151646, hidden_size=1536, num_hidden_layers=28,
                  num_attention_heads=12, num_key_value_heads=2, intermediate_size=8960, rms_norm_eps=1e-6,
                  rope_theta=1000000.0, max_position_embeddings=131072, sliding_window=131072),
    "mistral": MISTRAL,
    "llama_bias": dict(MISTRAL, architectures=["LlamaForCausalLM"], sliding_window=None, attention_bias=True),
    "nv_embed": dict(architectures=["NVEmbedModel"], text_config=MISTRAL,
                     latent_attention_config=dict(num_latents_value=512, num_cross_heads=8, cross_dim_head=4096,
                                                  latent_dim=4096)),
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_config_from_hf_matches_jax(name):
    """Every field of the JAX package's config equal; the port's own fields
    (DeepSeek-V3's MLA and MoE, a layout the JAX package lacks) at their
    defaults."""
    got = dataclasses.asdict(encoder_config_from_hf(HF_CONFIGS[name], max_length=128))
    want = dataclasses.asdict(jax_config_from_hf(HF_CONFIGS[name], max_length=128))
    assert {k: got[k] for k in want} == want
    defaults = dataclasses.asdict(EncoderConfig())
    assert {k: v for k, v in got.items() if k not in want} == {k: defaults[k] for k in got if k not in want}


HF_ERRORS = {
    "unsupported": dict(architectures=["GPT2Model"]),
    "rope_scaling": dict(MISTRAL, rope_scaling={"type": "linear", "factor": 2.0}),
    "sliding_window": dict(MISTRAL, sliding_window=256),
    "latent_dim": dict(HF_CONFIGS["nv_embed"], latent_attention_config=dict(latent_dim=1024)),
    "no_text_config": dict(architectures=["NVEmbedModel"]),
}


@pytest.mark.parametrize("name", list(HF_ERRORS))
def test_config_from_hf_errors_match_jax(name):
    with pytest.raises(ValueError) as want:
        jax_config_from_hf(HF_ERRORS[name])
    with pytest.raises(ValueError) as got:
        encoder_config_from_hf(HF_ERRORS[name])
    if name != "unsupported":
        assert str(got.value) == str(want.value)
        return
    # The port names every architecture the JAX package names, DeepSeek-V3's and Kimi Linear's.
    head, theirs = str(want.value).split("[")[0], str(want.value).split("[")[1].split("]")[0].split(", ")
    assert str(got.value).startswith(head)
    ours = str(got.value).split("[")[1].split("]")[0].split(", ")
    assert set(ours) == set(theirs) | {
        "'DeepseekV3Model'", "'DeepseekV3ForCausalLM'", "'KimiLinearModel'", "'KimiLinearForCausalLM'"
    }
