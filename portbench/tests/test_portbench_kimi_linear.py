"""The Kimi-Linear article encode-then-rank cell at a small size on the CPU,
the harness's look for a chip skipped: a tiny Kimi Linear encoder (5 layers
KDA, KDA, KDA, MLA, KDA, the first dense, D = 64, KDA 4 heads of 16, MLA 4
heads, 8 experts top-2 of which this device holds 4, one shared) feeding a
tiny latent tower, added by files and entries alone. It runs and comes out
correct, traced and not, its per-layer metrics read where the CPU has
something to read, the four readers read a recorded trace as their
formulas say, and each control of ``tools/kimi_linear_control.py`` fails a
limit."""

from __future__ import annotations

import copy
import json
import math
import time

import pytest
import torch

from portbench import harness, kda, spans, spec, trace
from portbench.reference import kimi_linear
from portbench.tests import tiny
from portbench.tools import kimi_linear_control

CELL = "tiny-kimi.article_encode_eval"
REAL = "kimilinear48b-latent2304.article_encode_eval"
ENCODER = {
    "architectures": ["KimiLinearForCausalLM"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 5, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 4,
    "num_experts_per_token": 2, "num_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
    "num_expert_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000, "num_nextn_predict_layers": 0,
    "mla_use_nope": True, "head_dim": 16, "bos_token_id": 99, "eos_token_id": 100,
    "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16, "num_heads": 4,
                           "short_conv_kernel_size": 4},
}
TOWER = dict(tiny.TOWERS["tiny-latent"], embedding_dim=64, reduced_dim=64, hidden_dim=256)
LIMITS = {"embed_gap": 1e-5, "route_mismatch": 0.0, "score_gap": 1e-5, "metric_gap": 1e-6}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("checkout"))
    base = json.loads((tiny.ROOT / "portbench" / "configs" / "kimilinear48b-latent2304.json").read_text())
    cfg = copy.deepcopy(base)
    cfg.update(ENCODER, name="tiny-kimi", tower=TOWER, news=24, dev_rows=20, token_width=128,
               encoder_dtype={"param_dtype": "float32", "compute_dtype": "float32"})
    cfg["published"]["num_experts"] = 8
    cfg["deployment"]["experts_held"] = [4, 4]  # the second card's share
    (root / "portbench" / "configs" / "tiny-kimi.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.ROOT / "portbench" / "traffic" / "article_encode_eval.json").read_text())
    mix.update(behaviors=tiny.BEHAVIORS, sample_rows=6,
               articles={"median_tokens": 30, "sigma": 0.75, "min_tokens": 4, "max_tokens": 120})
    mix["instruction_tokens"] = 5
    (root / "portbench" / "traffic" / "tiny-article_encode_eval.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-kimi", "source": "tests", "file": "portbench/configs/tiny-kimi.json",
                             "reduced": [], "why": "tiny widths for the CPU"})
    bench["workloads"].append({"name": CELL, "config": "tiny-kimi", "traffic": "tiny-article_encode_eval",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    assert spec.problems(bench, root) == []
    return root


@pytest.fixture(autouse=True)
def _threads():
    from news_recommendation_project_v2_torch.utils import profiling

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(before)


def run(root, trace=False, seed=2**31 + 9):
    return harness.run_cell(root, CELL, seed, 0.3, trace, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_article_encode_eval_cell_runs_correct(root, trace):
    r = run(root, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"embed_gap", "route_mismatch", "score_gap", "metric_gap"}
    assert r["checks"]["route_mismatch"]["value"] == 0.0
    if not trace:
        assert {"setup_s", "eval_impressions_per_s"} == set(r["metrics"])
        return
    m = r["metrics"]
    assert 0 < m["article_encode.mfu"]["value"] and math.isfinite(m["article_encode.mfu"]["value"])
    assert 0 <= m["device.idle_share.article_encode_eval"]["value"] <= 100
    rec = spans.recorded()
    c = rec.counters
    # Four KDA layers, each over every batch's rows x width and every real token.
    assert c["kda.tokens_computed"] == 4 * c["encode.tokens_computed"]
    assert c["kda.tokens_real"] == 4 * (c["encode.tokens_real"] + c["encode.pad_rows"])
    assert c["kda.launches"] == 0  # the plain path on the CPU launches no kernel
    # Three MoE layers; each token's 2 picks fall on the held half or not.
    assert 0 < c["moe.assignments_held"] < c["moe.assignments"] == 2 * c["moe.tokens_routed"]
    names = {s.name for s in rec.spans}
    assert {"kda.layer", "moe.layer", "encode.corpus"} <= names


def test_the_readers_read_a_recorded_trace(root):
    """The four readers on a recorded unit: counters and a span recorded by
    the port's profiler, a device trace of known kernel times."""
    from news_recommendation_project_v2_torch.utils import profiling

    with profiling.recording(True):
        with profiling.span("encode.corpus"):
            time.sleep(0.01)
        profiling.count("kda.tokens_real", 1000)
        profiling.count_device("moe.assignments_held", torch.tensor(40))
    cell = spec.cell(root, CELL)
    tr = trace.Trace(window_s=2.0, busy_s=1.5, kernel_s={"kda_chunked_kernel": 0.25, "other": 1.0}, idle_gaps=[])
    flops = 1e12
    r = harness.Readings(cell, {"kind": "article_encode_eval", "traced": {"encode_flops": flops}}, tr)
    seconds = sum(s.end_ns - s.start_ns for s in spans.recorded().spans if s.name == "encode.corpus") / 1e9
    got = {m["name"]: cell.reader(m["name"]).read(r) for m in cell.per_layer}
    assert got["device.idle_share.article_encode_eval"] == pytest.approx(25.0)
    assert got["kda.share.article_encode_eval"] == pytest.approx(100 * 0.25 / 1.5)
    ops, nbytes = kda.kda_work(cell.config, 1000)
    peaks = json.loads((tiny.ROOT / "portbench" / "peaks.json").read_text())
    want = 100 * max(ops / peaks["flops_per_s"]["float32"], nbytes / peaks["bytes_per_s"]) / 0.25
    assert got["kda.roofline.article_encode_eval"] == pytest.approx(want)
    assert got["article_encode.mfu"] == pytest.approx(100 * flops / seconds / peaks["flops_per_s"]["float32"])
    assert spans.recorded().counters["moe.assignments_held"] == 40


def test_kda_work_by_hand():
    # One head of 2 x 2, chunk 64: 3 * 4 state products and 64 * (3 * 2 + 2 * 2)
    # pair, solve and P U products: 652 multiply-adds a token.
    assert kda.recurrence_macs(1, 2, 2) == 652
    hf = {"linear_attn_config": {"num_heads": 1, "head_dim": 2}}
    ops, nbytes = kda.kda_work(hf, 10)
    assert ops == 2 * 652 * 10
    # q, k, v bf16 (3 * 2 * 2), log alpha float32 (2 * 4), beta (4), o bf16 (2 * 2).
    assert nbytes == (12 + 8 + 4 + 4) * 10


def test_forward_flops_counts_the_held_pairs():
    lens = [10, 7]
    base = kimi_linear.forward_flops(ENCODER, lens, 0)
    w = kimi_linear.widths(ENCODER)
    assert kimi_linear.forward_flops(ENCODER, lens, 5) - base == pytest.approx(5 * 2 * 3 * w["d"] * w["moe_ffn"])


def _no_l2_norm(mp):
    from news_recommendation_project_v2_torch.ops import kda as kda_ops

    mp.setattr(kda_ops, "l2norm", lambda x: x)


def _all_experts(mp):
    from news_recommendation_project_v2_torch.models import moe

    mp.setattr(moe, "held_picks", lambda picked, first, count: (picked.clamp_max(count - 1),
                                                                 torch.ones_like(picked, dtype=torch.bool)))


@pytest.mark.parametrize("fault", [_no_l2_norm, _all_experts], ids=["l2norm", "share"])
def test_a_broken_encoder_comes_out_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["embed_gap"]["value"] > r["checks"]["embed_gap"]["limit"]


def test_every_kimi_linear_control_fails_a_limit(root, monkeypatch):
    """Every control of the encoder and the tower's (``reduced_in_bfloat16``
    may pass at this size, where few scores fall into one bfloat16 value).
    The tiny rows are under 1,024 tokens, so the reset control resets every
    16 here."""
    monkeypatch.setitem(kimi_linear_control.CONTROLS, "state_reset_1024", {"reset": 16})
    rows = kimi_linear_control.run(root, CELL, [2**31 + 21], device="cpu")
    limits = spec.cell(root, CELL).limits
    failed = {r["reading"] for r in rows if any(r[k] > limits[k] for k in r if k in limits)}
    assert failed >= set(kimi_linear_control.CONTROLS) | {"tower_tf32", "tower_bfloat16", "altered"}, rows
