"""The encode-then-rank cell at a small size on the CPU, the harness's look
for a chip skipped: a tiny NV-Embed (2 layers, D = 64, 4 query heads over
2 key-value heads, a head of 16 latents x 2 heads of 32) feeding a tiny
latent tower, added by files and entries alone. It runs and comes out
correct, traced and not; a timed path that pools the instruction, or
whose head is skipped, comes out not correct, and so does each control of
``tools/nvembed_control.py``."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests import tiny
from portbench.tools import nvembed_control

CELL = "tiny-nvembed.encode_eval"
ENCODER = {
    "architectures": ["NVEmbedModel"],
    "text_config": {
        "architectures": ["MistralModel"], "vocab_size": 101, "hidden_size": 64, "intermediate_size": 160,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 4096, "max_position_embeddings": 512,
    },
    "latent_attention_config": {"num_latents_value": 16, "num_cross_heads": 2, "cross_dim_head": 32, "latent_dim": 64},
}
TOWER = dict(tiny.TOWERS["tiny-latent"], embedding_dim=64, reduced_dim=64, hidden_dim=256)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("checkout"))
    base = json.loads((tiny.ROOT / "portbench" / "configs" / "nvembed2-latent4096.json").read_text())
    cfg = copy.deepcopy(base)
    cfg.update(name="tiny-nvembed", encoder=ENCODER, tower=TOWER, news=40, dev_rows=30, token_width=64,
               encoder_dtype={"param_dtype": "float32", "compute_dtype": "float32"})
    (root / "portbench" / "configs" / "tiny-nvembed.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.ROOT / "portbench" / "traffic" / "encode_eval.json").read_text())
    mix["behaviors"] = tiny.BEHAVIORS
    (root / "portbench" / "traffic" / "tiny-encode_eval.json").write_text(json.dumps(mix))
    limits = {"embed_gap": 1e-5, "score_gap": 1e-5, "metric_gap": 1e-6}
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-nvembed", "source": "tests", "file": "portbench/configs/tiny-nvembed.json",
                             "reduced": [], "why": "tiny widths for the CPU"})
    bench["workloads"].append({"name": CELL, "config": "tiny-nvembed", "traffic": "tiny-encode_eval", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nvembed2-latent4096.encode_eval" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(root, trace=False, seed=2**31 + 9):
    return harness.run_cell(root, CELL, seed, 0.3, trace, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_encode_eval_cell_runs_correct(root, trace):
    r = run(root, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"embed_gap", "score_gap", "metric_gap"}
    if trace:
        m = r["metrics"]
        assert {"encode.share.encode_eval", "encode.mfu", "encode.pad_share.encode_eval",
                "device.idle_share.encode_eval"} <= set(m), m
        assert 0 < m["encode.share.encode_eval"]["value"] < 100
        assert 0 <= m["encode.pad_share.encode_eval"]["value"] < 100
    else:
        assert {"setup_s", "eval_impressions_per_s"} == set(r["metrics"])


def _instruction_pooled(mp):
    from news_recommendation_project_v2_torch.ops import encode

    mp.setattr(encode, "instruction_pool_mask", lambda tokenize, instruction, ids, mask: mask)


def _head_skipped(mp):
    from news_recommendation_project_v2_torch.models import news_encoder
    from news_recommendation_project_v2_torch.models.latent_attention import LatentAttentionTower

    class MeanHead(LatentAttentionTower):
        def forward(self, embeddings, attention_mask=None, generator=None):
            m = attention_mask.float()
            return (embeddings * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]

    mp.setattr(news_encoder, "LatentAttentionTower", MeanHead)


@pytest.mark.parametrize("fault", [_instruction_pooled, _head_skipped], ids=lambda f: f.__name__)
def test_a_broken_encode_comes_out_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["embed_gap"]["value"] > r["checks"]["embed_gap"]["limit"]


def test_every_control_fails_a_limit(root):
    """All but ``reduced_in_bfloat16``: over the tiny cell's 30 impressions
    of about ten candidates no two scores fall into one bfloat16 value, so
    rounding them moves no metric (at the cell's size it does)."""
    rows = nvembed_control.run(root, CELL, [2**31 + 21], device="cpu")
    limits = spec.cell(root, CELL).limits
    failed = {r["reading"] for r in rows if any(r[k] > limits[k] for k in r if k in limits)}
    assert {r["reading"] for r in rows} - failed == {"reduced_in_bfloat16"}, rows
    assert failed == {"mantissa3", "causal", "instruction_pooled", "last_layer_dropped", "mean_head", "tower_tf32",
                      "tower_bfloat16", "altered"}, rows
