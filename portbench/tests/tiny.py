"""A checkout with tiny cells for the CPU tests: the benchmark's folder
copied as it is, and new cells added by files and entries alone (a tiny
configuration of each tower, small mixes, their limits)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TOWERS = {
    "tiny-latent": {
        "kind": "latent", "embedding_dim": 32, "reduced_dim": 32, "hidden_dim": 128, "num_heads": 2,
        "num_layers": 1, "num_latents": 8, "latent_dim_head": 16, "dropout_rate": 0.1,
        "param_dtype": "float32", "compute_dtype": "float32",
    },
    "tiny-transformer": {
        "kind": "transformer", "embedding_dim": 32, "reduced_dim": 32, "num_heads": 8, "num_layers": 1,
        "dropout_rate": 0.1, "param_dtype": "float32", "compute_dtype": "float32",
    },
}
BEHAVIORS = {"mean_history": 8, "history_cap": 600, "mean_candidates": 10, "min_candidates": 2, "max_candidates": 40,
             "click_rate": 0.2}
LIMITS = {
    "train": {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3},
    "eval": {"score_gap": 1e-5, "metric_gap": 1e-6},
}


def make_root(tmp: Path) -> Path:
    """A checkout under ``tmp`` holding ``BENCHMARK.json`` with the tiny
    cells added, and the benchmark's folder with their files."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "portbench" / "configs" / "latent-e5large.json").read_text())
    for name, tower in TOWERS.items():
        cfg = copy.deepcopy(base)
        cfg.update(name=name, tower=tower, news=500, train_rows=160, dev_rows=96,
                   flat_train=tower["kind"] == "latent", flat_eval=tower["kind"] == "latent")
        cfg["train"]["batch_size"] = 64
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests", "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "tiny widths for the CPU"})
    mixes = {
        "tiny-train": {"kind": "train", "rows": "train_rows", "behaviors": BEHAVIORS},
        "tiny-eval": {"kind": "eval", "rows": "dev_rows", "behaviors": BEHAVIORS},
    }
    for name, mix in mixes.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = [("tiny-latent", "tiny-train"), ("tiny-transformer", "tiny-train"), ("tiny-latent", "tiny-eval")]
    for config, traffic in cells:
        kind = mixes[traffic]["kind"]
        name = f"{config}.{kind}"
        like = f"{config.removeprefix('tiny-')}-e5large.{kind}"  # the real cell it mirrors
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "tests"})
        (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(LIMITS[kind]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def reduced_root(tmp: Path, rows: dict) -> Path:
    """A checkout of the real cells with fewer rows (``rows``: key -> rows,
    in every configuration that has the key), every width kept."""
    root = Path(tmp) / "reduced"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update({k: v for k, v in rows.items() if k in cfg})
        path.write_text(json.dumps(cfg))
    return root
