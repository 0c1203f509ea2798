"""The port's DeepSeek-V3 layout (``NewsEncoder`` with ``arch="deepseek_v3"``,
Moonlight-16B-A3B's decoder: multi-head latent attention and a mixture of
experts) on the CPU, against the plain float32 reference of the benchmark
(``portbench/reference/moonlight.py``) on seeded random weights at a small
size: D = 64, 4 heads (16 plain + 16 rotary query and key dims, 16 value
dims), a 32-wide latent, 3 layers, the first dense, then 8 experts of 64,
top-2, and one shared expert.

float32 within 1e-5: the same operations in the same order, so only the
order of float sums can differ (they read 0 here). bfloat16 compute on the
same bfloat16 weights, against the float32 reference that applies the
program's picks of experts (a near tie of two experts' scores can flip
under bfloat16 rounding, and a flipped expert moves a token as far as a
layer does): within 0.015 of the unit vectors' elements, where eight seeds
read 0.0030-0.0062 and every product's operands rounded to 3 mantissa bits
read 0.0455-0.0757. Besides: the MoE's plain path against a loop over
tokens, the config reader and its refusals, the parameter count at
Moonlight's widths, the load of Hugging Face's per-expert names, the
real-token packing, and the memory model (NV-Embed's and e5's envelopes as
they were before this layout)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from news_recommendation_project_v2_torch.config import EncoderConfig
from news_recommendation_project_v2_torch.models.convert import encoder_state_dict_from_hf
from news_recommendation_project_v2_torch.models.moe import MoEBlock, MoEGate
from news_recommendation_project_v2_torch.models.news_encoder import (
    HashTokenizer,
    NewsEncoder,
    encoder_config_from_hf,
    real_token_positions,
)
from news_recommendation_project_v2_torch.ops.encode import encode_query_and_passage
from news_recommendation_project_v2_torch.utils.memory import encoder_activation_bytes, estimate_encoder_batch
from portbench import weights
from portbench.reference import moonlight
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]
HF = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "n_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 50000, "max_position_embeddings": 512,
    "num_nextn_predict_layers": 0,
}
MOONLIGHT = json.loads((ROOT / "portbench" / "configs" / "moonlight16b-latent2048.json").read_text())


def _params(seed=7, dtype=torch.float32):
    return moonlight.draw(HF, weights.device_generator(seed, 3, "cpu"), "cpu", dtype)


def _encoder(params, dtype):
    enc = NewsEncoder(encoder_config_from_hf(HF, param_dtype=dtype, compute_dtype=dtype, max_length=32)).eval()
    enc.load_state_dict(params)
    return enc


def _batch():
    """Right-padded rows of 12, 9, 5 and 3 real tokens."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(3, 101, (4, 12))).long()
    mask = torch.zeros(4, 12, dtype=torch.long)
    for i, n in enumerate((12, 9, 5, 3)):
        mask[i, :n] = 1
    return ids, mask


def _picks(enc):
    """The encoder's routers' picks, each row sorted, appended per call."""
    out = []
    for m in enc.modules():
        if isinstance(m, MoEGate):
            m.register_forward_hook(lambda mod, args, got: out.append(got[0].sort(-1).values))
    return out


def test_param_shapes_are_the_ports_state_dict():
    state = NewsEncoder(encoder_config_from_hf(HF, compute_dtype="float32")).state_dict()
    shapes = moonlight.param_shapes(HF)
    assert list(shapes) == list(state)
    assert all(tuple(state[k].shape) == s for k, (s, _) in shapes.items())


@pytest.mark.parametrize("count", ["host", "device"])
def test_float32_matches_the_reference(count):
    """With the real tokens' count handed in (as ``encode_corpus`` does) or
    counted from the mask."""
    params = _params()
    ids, mask = _batch()
    with torch.no_grad():
        got = _encoder(params, "float32")(ids, mask, real_tokens=int(mask.sum()) if count == "host" else None)
    want = moonlight.encode(params, HF, ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_bfloat16_matches_the_reference_that_takes_its_picks(seed):
    """Seed 1 flips a pick (its free-running reference lies 0.11 away)."""
    params = _params(seed, torch.bfloat16)
    ids, mask = _batch()
    enc = _encoder(params, "bfloat16")
    picks = _picks(enc)
    with torch.no_grad():
        got = enc(ids, mask).float()
    own = []
    want = moonlight.encode(params, HF, ids, mask, routes=own, forced=picks)
    assert (got - want).abs().max() <= 0.015
    assert all((a != b).any(-1).float().mean() <= 0.1 for a, b in zip(picks, own))
    ctl_picks: list = []
    rounded = moonlight.encode(params, HF, ids, mask, routes=ctl_picks, prod=moonlight.Products(3))
    held = moonlight.encode(params, HF, ids, mask, forced=ctl_picks)
    assert (rounded - held).abs().max() > 0.015


def _block(seed=0, bias=None):
    torch.manual_seed(seed)
    block = MoEBlock(16, 8, 2, 8, 1, 2.446, True)
    for t in block.parameters():
        t.data = torch.randn(t.shape) * (t.shape[-1] ** -0.5 if t.dim() > 1 else 0.02)
    if bias is not None:
        block.gate.e_score_correction_bias.data = bias
    return block.eval()


def _per_token(block, x):
    """The block's function one token at a time, one expert at a time."""
    g, ex, sh = block.gate, block.experts, block.shared_experts
    i = ex.down_proj.shape[-1]
    out = []
    for t in x:
        scores = torch.sigmoid(g.weight @ t)
        picked = torch.topk(scores + g.e_score_correction_bias, g.top_k).indices
        w = scores[picked] / scores[picked].sum() * g.scaling
        y = torch.zeros_like(t)
        for e, we in zip(picked.tolist(), w):
            h = F.silu(ex.gate_up_proj[e, :i] @ t) * (ex.gate_up_proj[e, i:] @ t)
            y = y + we * (ex.down_proj[e] @ h)
        shared = sh["down_proj"].weight @ (F.silu(sh["gate_proj"].weight @ t) * (sh["up_proj"].weight @ t))
        out.append(y + shared)
    return torch.stack(out)


@pytest.mark.parametrize("routing", ["random", "skewed", "empty_experts"])
def test_moe_plain_path_matches_a_loop_over_tokens(routing):
    """``skewed``: every token picks expert 0; ``empty_experts``: experts 4-7
    get no token."""
    bias = {
        "random": None,
        "skewed": torch.tensor([10.0] + [0.0] * 7),
        "empty_experts": torch.tensor([0.0] * 4 + [-10.0] * 4),
    }[routing]
    block = _block(1, bias)
    x = torch.randn(37, 16)
    with torch.no_grad():
        got = block(x)
        picked, _ = block.gate(x)
    counts = torch.bincount(picked.reshape(-1), minlength=8)
    if routing == "skewed":
        assert counts[0] == 37
    if routing == "empty_experts":
        assert (counts[4:] == 0).all()
    torch.testing.assert_close(got, _per_token(block, x), rtol=0, atol=1e-5)


def test_real_token_positions_pack_the_mask_row_major():
    _, mask = _batch()
    want = torch.nonzero(mask.reshape(-1)).reshape(-1)
    assert torch.equal(real_token_positions(mask), want)
    assert torch.equal(real_token_positions(mask, int(mask.sum())), want)


def test_config_from_moonlights_config_json():
    cfg = encoder_config_from_hf(MOONLIGHT, max_length=128, **MOONLIGHT["encoder_dtype"])
    assert (cfg.arch, cfg.pooling, cfg.hidden_dim, cfg.num_layers, cfg.num_heads) == ("deepseek_v3", "last", 2048, 27, 16)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts, cfg.moe_intermediate_size) == (
        64, 6, 2, 1408)
    assert (cfg.first_k_dense_replace, cfg.intermediate_dim, cfg.vocab_size) == (1, 11264, 163840)
    assert (cfg.routed_scaling_factor, cfg.norm_topk_prob, cfg.rope_theta, cfg.qkv_bias) == (2.446, True, 50000, False)
    with torch.device("meta"):
        enc = NewsEncoder(cfg)
    assert [layer.dense for layer in enc.layers] == [True] + [False] * 26


@pytest.mark.parametrize(
    "key, value, words",
    [
        ("q_lora_rank", 1536, "q_lora_rank"),
        ("n_group", 8, "n_group"),
        ("topk_group", 4, "topk_group"),
        ("rope_scaling", {"type": "yarn", "factor": 40}, "rope_scaling"),
        ("num_nextn_predict_layers", 1, "multi-token-prediction"),
        ("scoring_func", "softmax", "sigmoid"),
    ],
)
def test_config_refuses_what_the_layout_does_not_apply(key, value, words):
    hf = dict(MOONLIGHT, **{key: value})
    with pytest.raises(ValueError, match=words):
        encoder_config_from_hf(hf)


def test_param_count_at_moonlights_widths():
    """15.6 B parameters without the LM head, counted by hand from the
    published widths, as the reference lists them and as the port holds
    them."""
    d, h, v = 2048, 16, 163840
    attention = d * h * 192 + d * 576 + 512 + 512 * h * 256 + h * 128 * d + 2 * d
    moe = 64 * d + 64 + 64 * 3 * 1408 * d + 3 * 2816 * d
    by_hand = v * d + 27 * attention + 3 * d * 11264 + 26 * moe + d
    assert moonlight.param_count(MOONLIGHT) == by_hand
    with torch.device("meta"):
        enc = NewsEncoder(encoder_config_from_hf(MOONLIGHT))
    assert sum(p.numel() for p in enc.parameters()) == by_hand
    assert 15.55e9 < by_hand < 15.65e9


def _hf_names(state: dict) -> dict:
    """The port's state dict under Hugging Face's DeepseekV3ForCausalLM names:
    ``model.``, per-expert tensors, an ``lm_head``."""
    out = {"lm_head.weight": torch.zeros(3, 3)}
    for k, t in state.items():
        if k.endswith("experts.gate_up_proj"):
            i = t.shape[1] // 2
            for e in range(t.shape[0]):
                pre = f"model.{k[: -len('gate_up_proj')]}{e}."
                out[pre + "gate_proj.weight"], out[pre + "up_proj.weight"] = t[e, :i], t[e, i:]
        elif k.endswith("experts.down_proj"):
            for e in range(t.shape[0]):
                out[f"model.{k[: -len('down_proj')]}{e}.down_proj.weight"] = t[e]
        else:
            out["model." + k] = t
    return out


def test_hf_names_load_round_trip():
    params = _params()
    cfg = encoder_config_from_hf(HF, compute_dtype="float32")
    hf = _hf_names(params)
    assert "model.layers.1.mlp.experts.7.down_proj.weight" in hf and "model.layers.1.mlp.gate.e_score_correction_bias" in hf
    loaded = encoder_state_dict_from_hf(hf, cfg)
    assert set(loaded) == set(params)
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    broken = {k: v for k, v in hf.items() if k != "model.layers.2.mlp.experts.3.up_proj.weight"}
    with pytest.raises(ValueError, match="expert tensors"):
        encoder_state_dict_from_hf(broken, cfg)


def test_bucketed_encode_matches_the_fixed_width_one():
    """``encode_query_and_passage`` by buckets (the real-token counts handed
    to the encoder batch by batch) against one fixed-width pass."""
    enc = _encoder(_params(), "float32")
    tok = HashTokenizer(vocab_size=101, max_length=40)
    texts = [" ".join(f"w{j}" for j in range(n)) for n in (3, 17, 9, 30, 1, 12, 25)]
    bucketed = encode_query_and_passage(enc, tok, texts, "query: ", 4, buckets=(8, 16), device="cpu")
    fixed = encode_query_and_passage(enc, tok, texts, "query: ", 4, device="cpu")
    for got, want in zip(bucketed, fixed):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_passage_rows_are_queued_before_the_query_rows_are_tokenized():
    """The host tokenizes the query rows only once the passage rows' batches
    are queued (so the card encodes while the host tokenizes); the tables
    are those of tokenizing both first."""
    enc = _encoder(_params(), "float32")
    tok = HashTokenizer(vocab_size=101, max_length=40)
    texts = [" ".join(f"w{j}" for j in range(n)) for n in (3, 17, 9, 30, 1, 12, 25)]
    events = []

    def tokenize(batch):
        events.append(("tokenize", len(batch)))
        return tok(batch)

    hook = enc.register_forward_pre_hook(lambda m, args: events.append(("encode", args[0].shape[1])))
    try:
        query, passage = encode_query_and_passage(enc, tokenize, texts, "query: ", 4, buckets=(8, 16), device="cpu")
    finally:
        hook.remove()
    first_query = events.index(("tokenize", len(texts)), 1)
    assert events[0] == ("tokenize", len(texts))
    assert all(e[0] == "encode" for e in events[1:first_query]) and first_query > 1
    assert all(e[0] == "encode" for e in events[first_query + 1 :])
    ids, mask = tok(texts)
    q_ids, q_mask = tok(["query: " + t for t in texts])
    with torch.no_grad():
        want_p = enc(torch.from_numpy(ids), torch.from_numpy(mask))
        want_q = enc(torch.from_numpy(q_ids), torch.from_numpy(q_mask))
    torch.testing.assert_close(passage, want_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(query, want_q, rtol=0, atol=1e-5)


# The parent's envelopes (bytes of one row) and batches on an 80 GB card at
# 32, 64, 128 and 512 tokens, before the DeepSeek-V3 layout came.
ENVELOPES = {
    "nvembed": [[32, 13434880, 1488], [64, 27525120, 720], [128, 57671680, 344], [512, 293601280, 64]],
    "e5": [[32, 1474560, 13560], [64, 3276800, 6096], [128, 7864320, 2536], [512, 62914560, 312]],
}


@pytest.mark.parametrize("name", list(ENVELOPES))
def test_memory_model_of_the_other_encoders_is_unchanged(name):
    if name == "nvembed":
        nv = json.loads((ROOT / "portbench" / "configs" / "nvembed2-latent4096.json").read_text())
        cfg = encoder_config_from_hf(nv["encoder"], max_length=128, **nv["encoder_dtype"])
    else:
        cfg = EncoderConfig()
    got = [[w, encoder_activation_bytes(cfg, 1, w), estimate_encoder_batch(cfg, w, hbm_budget_bytes=80 * 10**9)]
           for w, _, _ in ENVELOPES[name]]
    assert got == ENVELOPES[name]


def test_memory_model_of_moonlight_counts_the_moe():
    """A token's envelope holds at least the MoE's buffers of its 6 pairs at
    the down launch (the gathered rows and h in bf16, the weighted outputs
    in float32), and the batch the model picks at 64 tokens fits a quarter
    of an 80 GB card."""
    cfg = encoder_config_from_hf(MOONLIGHT, max_length=128, **MOONLIGHT["encoder_dtype"])
    row = encoder_activation_bytes(cfg, 1, 64)
    k, d, i = 6, 2048, 1408
    assert row >= 64 * (k * d * 2 + k * i * 2 + k * d * 4)
    assert estimate_encoder_batch(cfg, 64, hbm_budget_bytes=80 * 10**9) * row <= 20 * 10**9
