"""The Moonlight encode-then-rank cell at a small size on the CPU, the
harness's look for a chip skipped: a tiny DeepSeek-V3 encoder (3 layers,
the first dense, D = 64, 4 heads, a 32-wide latent, 8 experts top-2 and one
shared) feeding a tiny latent tower, added by files and entries alone. It
runs and comes out correct, traced and not, its per-layer metrics read
where the CPU has something to read (the spans and counters; the device's
figures need the card), and each control of ``tools/moonlight_control.py``
fails a limit."""

from __future__ import annotations

import copy
import json
import math
import time

import pytest
import torch

from portbench import harness, spans, spec
from portbench.tests import tiny
from portbench.tools import moonlight_control

CELL = "tiny-moonlight.moe_encode_eval"
ENCODER = {
    "architectures": ["DeepseekV3ForCausalLM"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "moe_intermediate_size": 64, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "n_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 50000, "max_position_embeddings": 512,
    "num_nextn_predict_layers": 0, "bos_token_id": 99, "eos_token_id": 100,
}
TOWER = dict(tiny.TOWERS["tiny-latent"], embedding_dim=64, reduced_dim=64, hidden_dim=256)
LIMITS = {"embed_gap": 1e-5, "route_mismatch": 0.0, "score_gap": 1e-5, "metric_gap": 1e-6}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("checkout"))
    base = json.loads((tiny.ROOT / "portbench" / "configs" / "moonlight16b-latent2048.json").read_text())
    cfg = copy.deepcopy(base)
    cfg.update(ENCODER, name="tiny-moonlight", tower=TOWER, news=40, dev_rows=30, token_width=64,
               encoder_dtype={"param_dtype": "float32", "compute_dtype": "float32"})
    (root / "portbench" / "configs" / "tiny-moonlight.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.ROOT / "portbench" / "traffic" / "moe_encode_eval.json").read_text())
    mix["behaviors"] = tiny.BEHAVIORS
    (root / "portbench" / "traffic" / "tiny-moe_encode_eval.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moonlight", "source": "tests",
                             "file": "portbench/configs/tiny-moonlight.json", "reduced": [],
                             "why": "tiny widths for the CPU"})
    bench["workloads"].append({"name": CELL, "config": "tiny-moonlight", "traffic": "tiny-moe_encode_eval",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "moonlight16b-latent2048.moe_encode_eval" in m.get("workloads", []):
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
def test_the_tiny_moe_encode_eval_cell_runs_correct(root, trace):
    r = run(root, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"embed_gap", "route_mismatch", "score_gap", "metric_gap"}
    assert r["checks"]["route_mismatch"]["value"] == 0.0
    if not trace:
        assert {"setup_s", "eval_impressions_per_s"} == set(r["metrics"])
        return
    m = r["metrics"]
    assert 0 < m["moe_encode.mfu"]["value"] and math.isfinite(m["moe_encode.mfu"]["value"])
    assert 0 <= m["device.idle_share.moe_encode_eval"]["value"] <= 100
    counters = spans.recorded().counters
    # Two MoE layers, each routing every real token and the one live slot of
    # each pad row that fills a batch.
    tokens, rows = counters["encode.tokens_real"], counters["encode.rows"]
    assert 2 * tokens < counters["moe.tokens_routed"] < 2 * (tokens + rows)
    assert counters["moe.assignments"] == 2 * counters["moe.tokens_routed"]
    assert counters["moe.grouped_launches"] == 0  # the plain path on the CPU launches no kernel
    assert any(s.name == "moe.layer" for s in spans.recorded().spans)


def _bias_ignored(mp):
    from news_recommendation_project_v2_torch.models import moe

    class Unbiased(moe.MoEGate):
        def forward(self, x):
            with torch.no_grad():
                saved = self.e_score_correction_bias.clone()
                self.e_score_correction_bias.zero_()
                try:
                    return super().forward(x)
                finally:
                    self.e_score_correction_bias.copy_(saved)

    mp.setattr(moe, "MoEGate", Unbiased)


def _shared_left_out(mp):
    from news_recommendation_project_v2_torch.models import moe

    mp.setattr(moe, "swiglu", lambda mlp, x: torch.zeros_like(x))  # the MoE block's shared experts alone


@pytest.mark.parametrize(
    "fault, caught", [(_bias_ignored, "route_mismatch"), (_shared_left_out, "embed_gap")], ids=["bias", "shared"]
)
def test_a_broken_moe_comes_out_not_correct(root, fault, caught, monkeypatch):
    """The reference applies the program's picks, so a wrong choice of
    experts shows in ``route_mismatch`` and a wrong sum in ``embed_gap``."""
    fault(monkeypatch)
    r = run(root)
    assert not r["correct"], r["checks"]
    assert r["checks"][caught]["value"] > r["checks"][caught]["limit"]


def test_every_moonlight_control_fails_a_limit(root):
    """All but ``reduced_in_bfloat16`` (as in the NV-Embed cell's test: over
    the tiny cell's 30 impressions no two scores fall into one bfloat16
    value)."""
    rows = moonlight_control.run(root, CELL, [2**31 + 21], device="cpu")
    limits = spec.cell(root, CELL).limits
    failed = {r["reading"] for r in rows if any(r[k] > limits[k] for k in r if k in limits)}
    assert {r["reading"] for r in rows} - failed == {"reduced_in_bfloat16"}, rows
    assert failed >= set(moonlight_control.CONTROLS) | {"tower_tf32", "tower_bfloat16", "altered"}, rows
