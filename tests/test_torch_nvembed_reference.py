"""The port's NV-Embed layout (``NewsEncoder`` with ``bidirectional`` and the
latent-pool head, built by ``encoder_config_from_hf``) against the plain
float32 reference of the benchmark (``portbench/reference/nvembed.py``), on
seeded random weights at a small size on the CPU: 2 layers, D = 64, 4 query
heads over 2 key-value heads, a head of 16 latents x 2 heads of 32.

float32 within 1e-5 (the same sums in other orders); bfloat16 compute on
the same bfloat16 weights within two bfloat16 units of the largest value
(units of ``2**-7`` of it: every product's result, and the backbone's
residual stream, round to bfloat16, and over two layers and the head the
gap read 0.75 to 1.39 units on eight seeds); the instruction's tokens
reach the other tokens' states but not the mean; the bucketed
``encode_query_and_passage`` against the fixed-width one."""

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer, NewsEncoder, encoder_config_from_hf
from news_recommendation_project_v2_torch.ops.encode import encode_query_and_passage, instruction_pool_mask
from portbench import weights
from portbench.reference import nvembed
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

HF = {
    "architectures": ["NVEmbedModel"],
    "text_config": {
        "architectures": ["MistralModel"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 4096, "max_position_embeddings": 512,
    },
    "latent_attention_config": {"num_latents_value": 16, "num_cross_heads": 2, "cross_dim_head": 32, "latent_dim": 64},
}
INSTRUCTION = "Instruct: retrieve the news this reader would also read Query: "


def _params(dtype=torch.float32):
    shapes = nvembed.param_shapes(HF)
    p = weights.make_params(shapes, weights.device_generator(7, 3, "cpu"), "cpu")
    return {k: v.to(dtype) for k, v in p.items()}


def _encoder(params, dtype):
    cfg = encoder_config_from_hf(HF, param_dtype=dtype, compute_dtype=dtype, max_length=32)
    enc = NewsEncoder(cfg).eval()
    enc.load_state_dict(params)
    return enc


def _batch():
    """Right-padded rows of 12, 9, 5 and 3 real tokens; the first 4 of each
    row (BOS and a 3-token instruction) out of the pool."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(3, 101, (4, 12))).long()
    mask = torch.zeros(4, 12, dtype=torch.long)
    for i, n in enumerate((12, 9, 5, 3)):
        mask[i, :n] = 1
    pool = mask.clone()
    pool[:, :2] = 0
    return ids, mask, pool


def test_param_shapes_are_the_ports_state_dict():
    cfg = encoder_config_from_hf(HF, compute_dtype="float32")
    state = NewsEncoder(cfg).state_dict()
    shapes = nvembed.param_shapes(HF)
    assert list(shapes) == list(state)
    assert all(tuple(state[k].shape) == s for k, (s, _) in shapes.items())


@pytest.mark.parametrize("pooled", ["mask", "pool_mask"])
def test_float32_matches_the_reference(pooled):
    params = _params()
    ids, mask, pool = _batch()
    pool = None if pooled == "mask" else pool
    with torch.no_grad():
        got = _encoder(params, "float32")(ids, mask, pool)
    want = nvembed.encode(params, HF, ids, mask, pool)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_bfloat16_within_two_units_of_the_largest_value():
    """The port computing in bfloat16 (the head too) on bfloat16 weights, the
    reference in float32 on the same weights upcast."""
    params = _params(torch.bfloat16)
    ids, mask, pool = _batch()
    with torch.no_grad():
        got = _encoder(params, "bfloat16")(ids, mask, pool)
    want = nvembed.encode(params, HF, ids, mask, pool)
    unit = torch.finfo(torch.bfloat16).eps * float(want.abs().max())
    gap = float((got - want).abs().max())
    assert 0 < gap <= 2 * unit, (gap, unit)


def test_instruction_reaches_the_states_but_not_the_mean():
    params = _params()
    enc = _encoder(params, "float32")
    ids, mask, pool = _batch()
    other = ids.clone()
    other[:, 1] = torch.where(ids[:, 1] == 5, 6, 5)  # an instruction token changed
    with torch.no_grad():
        states = [enc.latent_pool(enc.hidden_states(x, mask)) for x in (ids, other)]
        pooled = enc(ids, mask, pool)
    live = pool.bool()
    assert not torch.allclose(states[0][live], states[1][live], rtol=0, atol=1e-4)
    m = pool.float()[..., None]
    mean = (states[0] * m).sum(1) / m.sum(1)
    np.testing.assert_allclose(pooled.numpy(), (mean / mean.norm(dim=-1, keepdim=True)).numpy(), rtol=0, atol=1e-6)
    with torch.no_grad():
        assert not torch.allclose(enc(ids, mask), pooled, rtol=0, atol=1e-3)


def test_instruction_pool_mask_clears_bos_and_the_instruction():
    tok = HashTokenizer(vocab_size=101, max_length=32)
    texts = ["stocks rally as markets rebound", "one", "a b c d e f"]
    ids, mask = tok([INSTRUCTION + t for t in texts])
    pool = instruction_pool_mask(tok, INSTRUCTION, ids, mask)
    n = len(INSTRUCTION.split()) + 1  # BOS and the instruction's words
    assert (pool[:, :n] == 0).all()
    assert np.array_equal(pool[:, n:], mask[:, n:])
    assert (pool.sum(1) == np.array([len(t.split()) + 1 for t in texts])).all()  # the title and EOS


def test_query_and_passage_bucketed_match_fixed_width():
    """The query rows' pool leaves the instruction out in both routes; each
    table bucketed within 1e-5 of the fixed-width encode, and the query
    table equal to the reference with the instruction out of the pool."""
    params = _params()
    enc = _encoder(params, "float32")
    tok = HashTokenizer(vocab_size=101, max_length=32)
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{w}" for w in rng.integers(0, 500, size=int(c))) for c in rng.integers(1, 20, size=11)]
    fixed = encode_query_and_passage(enc, tok, texts, INSTRUCTION, batch_size=4, device="cpu")
    bucketed = encode_query_and_passage(enc, tok, texts, INSTRUCTION, batch_size=4, buckets=(8, 16), device="cpu")
    for f, b in zip(fixed, bucketed, strict=True):
        np.testing.assert_allclose(b.numpy(), f.numpy(), rtol=0, atol=1e-5)
    ids, mask = tok([INSTRUCTION + t for t in texts])
    pool = instruction_pool_mask(tok, INSTRUCTION, ids, mask)
    want = nvembed.encode(params, HF, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pool))
    np.testing.assert_allclose(fixed[0].numpy(), want.numpy(), rtol=0, atol=1e-5)
    ids, mask = tok(texts)
    want = nvembed.encode(params, HF, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(fixed[1].numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_forward_flops_by_hand():
    """Two rows of 3 and 5 tokens at the small widths, counted by hand."""
    d, hd, h, kv, f, layers, n, inner = 64, 16, 4, 2, 160, 2, 16, 64
    per_token = layers * (2 * d * hd * (2 * h + 2 * kv) + 6 * d * f)
    per_token += 4 * d * inner + 4 * n * inner + 16 * d * d + 8 * d * d
    want = 8 * per_token + (9 + 25) * 4 * h * hd * layers + 4 * n * d * inner
    assert nvembed.forward_flops(HF, [3, 5], calls=1) == want
