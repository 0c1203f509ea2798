"""The port's Kimi Linear layout (``NewsEncoder`` with ``arch="kimi_linear"``:
Kimi Delta Attention and NoPE latent attention layers, a mixture of experts
holding a share of its experts) on the CPU, against the plain float32
reference of the benchmark (``portbench/reference/kimi_linear.py``, its KDA
one token at a time) on seeded random weights at a small size: D = 64, KDA
4 heads of 16 with convs of 4, MLA 4 heads (16 plain + 8 unrotated query and
key dims, 16 value dims, a 32-wide latent), 5 layers KDA, KDA, KDA, MLA,
KDA, the first dense, then 8 experts of 64, top-2, of which 4 are held, and
one shared expert; rows of 1 to 150 tokens, across the recurrence's chunks
of 16.

float32 within 1e-5: the same equations, the recurrence chunked in the
program and one token at a time in the reference, so only the order of
float sums differs (it reads 1.4e-6 here). bfloat16 compute on the
same bfloat16 weights, against the float32 reference that applies the
program's picks of experts: within ``BF16_GAP`` of the unit vectors'
elements, where eight seeds read 0.0073-0.0167 and every product's
operands rounded to 3 mantissa bits read 0.081-0.270 (seeds 0-7). Besides: the plain chunked
recurrence against the one token at a time with decays near 0 and near 1,
the expert share, the config reader and its refusals, the parameter counts
at Kimi-Linear's widths, and the buckets and memory envelopes of the
configurations that came before."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.config import EncoderConfig
from news_recommendation_project_v2_torch.models.moe import MoEBlock
from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder, encoder_config_from_hf
from news_recommendation_project_v2_torch.ops.encode import TOKEN_BUCKETS
from news_recommendation_project_v2_torch.ops.kda import recurrent_kda, reference_kda
from news_recommendation_project_v2_torch.utils.memory import encoder_activation_bytes, estimate_encoder_batch
from portbench import weights
from portbench.drivers.article_encode_eval import full_config
from portbench.reference import kimi_linear
from portbench.reference.nvembed import Products
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]
HF = {
    "architectures": ["KimiLinearForCausalLM"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 5, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 8,
    "num_experts_per_token": 2, "num_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
    "num_expert_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000, "num_nextn_predict_layers": 0,
    "mla_use_nope": True, "head_dim": 16, "rope_scaling": None,
    "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16, "num_heads": 4,
                           "short_conv_kernel_size": 4},
}
HELD = (4, 4)
KIMI = json.loads((ROOT / "portbench" / "configs" / "kimilinear48b-latent2304.json").read_text())
LENS = (150, 97, 64, 33, 17, 16, 5, 1)
# The bf16 tolerance: between the program's largest reading over seeds and
# the 3-mantissa-bit control's smallest (the module's docstring).
BF16_GAP = 0.04


def _params(seed=7, dtype=torch.float32, held=HELD):
    return kimi_linear.draw(HF, weights.device_generator(seed, 3, "cpu"), "cpu", dtype, held)


def _encoder(params, dtype, held=HELD):
    cfg = encoder_config_from_hf(HF, experts_held=held, param_dtype=dtype, compute_dtype=dtype, max_length=160)
    enc = NewsEncoder(cfg).eval()
    enc.load_state_dict(params)
    return enc


def _batch(seed=3):
    """Right-padded rows of ``LENS`` real tokens."""
    rng = np.random.default_rng(seed)
    t = max(LENS)
    ids = torch.from_numpy(rng.integers(3, 101, (len(LENS), t))).long()
    mask = torch.zeros(len(LENS), t, dtype=torch.long)
    for i, n in enumerate(LENS):
        mask[i, :n] = 1
    return ids, mask


def _rows(ids, mask):
    return [ids[i, : int(mask[i].sum())] for i in range(len(ids))]


def _picks(enc):
    """The encoder's routers' picks, each row sorted, appended per call."""
    from news_recommendation_project_v2_torch.models.moe import MoEGate

    out = []
    for m in enc.modules():
        if isinstance(m, MoEGate):
            m.register_forward_hook(lambda mod, args, res: out.append(res[0].sort(-1).values))
    return out


def test_param_shapes_are_the_ports_state_dict():
    enc = NewsEncoder(encoder_config_from_hf(HF, experts_held=HELD, param_dtype="float32"))
    got = {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    assert got == {k: s for k, (s, _) in kimi_linear.param_shapes(HF, HELD).items()}


@pytest.mark.parametrize("held", [HELD, None], ids=["share", "all"])
def test_float32_matches_the_reference(held):
    params = _params(held=held)
    enc = _encoder(params, "float32", held)
    ids, mask = _batch()
    with torch.no_grad():
        got = enc(ids, mask, real_tokens=int(mask.sum()))
    want = kimi_linear.encode_rows(params, HF, _rows(ids, mask), held)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _bf16_gap(seed, prod=None):
    """The largest element gap between the program's bf16 vectors, or the
    reference under ``prod`` (a control), and the float32 reference that
    applies their picks of experts."""
    params = _params(seed, torch.bfloat16)
    ids, mask = _batch(seed)
    rows = _rows(ids, mask)
    if prod is None:
        enc = _encoder(params, "bfloat16")
        picks = _picks(enc)
        with torch.no_grad():
            got = enc(ids, mask, real_tokens=int(mask.sum()))
        forced = picks  # the real tokens', row by row: the reference's order
    else:
        forced = []
        got = kimi_linear.encode_rows(params, HF, rows, HELD, prod=prod, routes=forced)
    want = kimi_linear.encode_rows(params, HF, rows, HELD, forced=forced)
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_bfloat16_matches_the_reference_that_takes_its_picks(seed):
    assert _bf16_gap(seed) < BF16_GAP


def test_a_3_mantissa_bit_reference_fails_the_bf16_tolerance():
    assert _bf16_gap(0, Products(3)) > BF16_GAP


@pytest.mark.parametrize("decay", ["near_0", "near_1", "mixed"])
def test_plain_chunked_kda_matches_the_per_token_recurrence(decay):
    """The plain chunked recurrence (chunks of 16, a row of 70 tokens and
    one of 33) against the recurrence one token at a time: decays near 0
    (log alpha at most -50, so a chunk's cumulative decay passes -800 and
    exp of it underflows), near 1 (log alpha above -1e-3: the state carries
    the whole row) and a mix over channels."""
    gen = torch.Generator().manual_seed(2)
    b, t, h, d = 2, 70, 3, 16
    q = torch.nn.functional.normalize(torch.randn(b, t, h, d, generator=gen), dim=-1) * d**-0.5
    k = torch.nn.functional.normalize(torch.randn(b, t, h, d, generator=gen), dim=-1)
    v = torch.randn(b, t, h, d, generator=gen)
    u = torch.rand(b, t, h, d, generator=gen)
    near_0, near_1 = -50.0 - 30.0 * u, -1e-3 * u
    log_alpha = {"near_0": near_0, "near_1": near_1,
                 "mixed": torch.where(torch.arange(d) % 2 == 0, near_0, near_1)}[decay]
    beta = torch.rand(b, t, h, generator=gen)
    lens = torch.tensor([70, 33], dtype=torch.int32)
    got = reference_kda(q, k, v, log_alpha, beta, lens)
    want = recurrent_kda(q, k, v, log_alpha, beta)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1, :33], want[1, :33], rtol=0, atol=1e-5)
    assert (got[1, 33:] == 0).all()


def test_two_shares_add_up_to_the_whole_layer():
    """The parts of a MoE layer's output that the two cards' shares of 4
    experts give, with the shared expert (which both compute) counted once,
    add up to the uncut layer's output."""
    torch.manual_seed(0)
    whole = MoEBlock(64, 8, 2, 64, 1, 2.446, True)
    for p in whole.parameters():
        p.data = torch.randn(p.shape) * (p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1)
    parts = []
    for first in (0, 4):
        block = MoEBlock(64, 8, 2, 64, 1, 2.446, True, held=(first, 4))
        state = dict(whole.state_dict())
        for name in ("experts.gate_up_proj", "experts.down_proj"):
            state[name] = state[name][first : first + 4]
        block.load_state_dict(state)
        parts.append(block)
    x = torch.randn(300, 64)
    with torch.no_grad():
        sh = whole.shared_experts
        shared = sh["down_proj"](torch.nn.functional.silu(sh["gate_proj"](x)) * sh["up_proj"](x))
        got = parts[0](x) + parts[1](x) - shared
        want = whole(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_config_from_kimi_linears_config_json():
    cfg = encoder_config_from_hf(full_config(KIMI), experts_held=tuple(KIMI["deployment"]["experts_held"]))
    assert cfg.arch == "kimi_linear" and cfg.pooling == "last"
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "mla"] == [3, 7, 11, 15, 19, 23, 26]
    assert cfg.layer_kinds.count("kda") == 20 and len(cfg.layer_kinds) == 27
    assert (cfg.kda_num_heads, cfg.kda_head_dim, cfg.short_conv_kernel_size) == (32, 128, 4)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts) == (256, 8, 1)
    assert (cfg.moe_intermediate_size, cfg.intermediate_dim, cfg.first_k_dense_replace) == (1024, 9216, 1)
    assert cfg.experts_held == (0, 128) and cfg.mla_use_nope and cfg.head_dim is None
    assert (cfg.routed_scaling_factor, cfg.norm_topk_prob) == (2.446, True)


@pytest.mark.parametrize(
    "key, value, words",
    [
        ("q_lora_rank", 1536, "q_lora_rank"),
        ("num_expert_group", 8, "num_expert_group"),
        ("topk_group", 4, "topk_group"),
        ("rope_scaling", {"type": "yarn", "factor": 4.0}, "rope_scaling"),
        ("num_nextn_predict_layers", 1, "multi-token-prediction"),
        ("moe_router_activation_func", "softmax", "sigmoid router"),
        ("mla_use_nope", False, "without rotation"),
        ("linear_attn_config", "missing_layer", "exactly once"),
        ("linear_attn_config", "twice", "exactly once"),
        ("experts_held", (200, 128), "whole range"),
        ("experts_held", (0, 0), "whole range"),
        ("experts_held", (0, 64, 128), "whole range"),
    ],
)
def test_config_refuses_what_the_layout_does_not_apply(key, value, words):
    hf = copy.deepcopy(full_config(KIMI))
    held = (0, 128)
    if key == "experts_held":
        held = value
    elif key == "linear_attn_config":
        lac = hf["linear_attn_config"]
        if value == "missing_layer":
            lac["kda_layers"] = lac["kda_layers"][1:]
        else:
            lac["full_attn_layers"] = lac["full_attn_layers"] + [1]
    else:
        hf[key] = value
    with pytest.raises(ValueError, match=words):
        encoder_config_from_hf(hf, experts_held=held)


def test_param_counts_at_kimi_linears_widths():
    """This card's share (128 of 256 experts) is 25.2 B parameters, the
    whole model without its LM head 48.7 B, by a hand count of the layers."""
    hf = full_config(KIMI)
    d, inner, hd, h = 2304, 32 * 128, 128, 32
    kda = 3 * inner * d + 3 * inner * 4 + h + inner + hd * d + inner * hd + h * d + hd * d + inner * hd + hd + d * inner
    mla = 2304 * 32 * 192 + 2304 * 576 + 512 + 512 * 32 * 256 + 32 * 128 * 2304
    expert = 3 * d * 1024
    moe = lambda held: 256 * d + 256 + held * expert + expert  # noqa: E731
    base = 163840 * d + 20 * kda + 7 * mla + 27 * 2 * d + 3 * d * 9216 + d
    assert kda == 39_514_272 and mla == 29_114_880
    for held, billions in ((128, 25.2), (256, 48.7)):
        want = base + 26 * moe(held)
        assert kimi_linear.param_count(hf, (0, held)) == want
        assert round(want / 1e9, 1) == billions


def test_the_buckets_of_the_configurations_before_are_unchanged():
    """The buckets an encode takes below each earlier configuration's width
    (NV-Embed's and Moonlight's 128, e5's 512) are those the bucket list
    gave before it reached 4,096."""
    before = (32, 64, 128, 256, 512)
    for width in (40, 64, 128, 512):
        got = tuple(sorted({b for b in TOKEN_BUCKETS if b < width})) + (width,)
        assert got == tuple(sorted({b for b in before if b < width})) + (width,)
    assert TOKEN_BUCKETS[-3:] == (1024, 2048, 4096)


# The parent's envelopes (bytes of one row) and batches on an 80 GB card at
# 32, 64, 128 and 512 tokens, before the Kimi Linear layout came.
ENVELOPES = {
    "nvembed": [[32, 13434880, 1488], [64, 27525120, 720], [128, 57671680, 344], [512, 293601280, 64]],
    "moonlight": [[32, 5208064, 3840], [64, 10743808, 1856], [128, 22798336, 872], [512, 122650624, 160]],
    "e5": [[32, 1474560, 13560], [64, 3276800, 6096], [128, 7864320, 2536], [512, 62914560, 312]],
}


@pytest.mark.parametrize("name", list(ENVELOPES))
def test_memory_model_of_the_other_encoders_is_unchanged(name):
    if name == "nvembed":
        nv = json.loads((ROOT / "portbench" / "configs" / "nvembed2-latent4096.json").read_text())
        cfg = encoder_config_from_hf(nv["encoder"], max_length=128, **nv["encoder_dtype"])
    elif name == "moonlight":
        ml = json.loads((ROOT / "portbench" / "configs" / "moonlight16b-latent2048.json").read_text())
        cfg = encoder_config_from_hf(ml, max_length=128, **ml["encoder_dtype"])
    else:
        cfg = EncoderConfig()
    got = [[w, encoder_activation_bytes(cfg, 1, w), estimate_encoder_batch(cfg, w, hbm_budget_bytes=80 * 10**9)]
           for w, _, _ in ENVELOPES[name]]
    assert got == ENVELOPES[name]


def test_memory_model_of_kimi_linear_counts_the_kda_block_and_the_moe():
    """A token's envelope holds at least KDA's q, k, v, log alpha and the
    MoE's buffers of its 8 pairs at the down launch, a row the recurrence's
    2 MB state, no [T, T] block; the batch the model picks at 4,096 tokens
    fits a quarter of an 80 GB card."""
    cfg = encoder_config_from_hf(full_config(KIMI), experts_held=(0, 128), max_length=4096,
                                 **KIMI["encoder_dtype"])
    k, d, i, inner = 8, 2304, 1024, 4096
    for w in (1024, 4096):
        row = encoder_activation_bytes(cfg, 1, w)
        assert row >= w * max(3 * inner * 2 + inner * 4, k * d * 2 + k * i * 2 + k * d * 4) + 32 * 128 * 128 * 4
        assert row < w * 300_000  # linear in the width: no attention logits
        assert estimate_encoder_batch(cfg, w, hbm_budget_bytes=80 * 10**9) * row <= 20 * 10**9
