"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its limits, its driver and the readers of its per-layer
metrics, each found by name under the benchmark's folder.

- configuration ``c``: ``configs/<c>.json`` (the file ``BENCHMARK.json``
  names); its reference tower: the module ``reference/<tower kind>.py``;
- traffic ``t``: ``traffic/<t>.json``, whose ``kind`` names the driver,
  the module ``drivers/<kind>.py``;
- cell ``w``: its comparison limits, ``limits/<w>.json``;
- per-layer metric ``m``: its reader, ``metrics/<m>.py``.

A new cell, mix, configuration or metric is a new file and an entry, with
no edit to a file that exists.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
BENCH = "portbench"


def load_module(path: Path) -> ModuleType:
    """A module from its file, under a name made from its path."""
    name = "portbench_file_" + re.sub(r"\W", "_", str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the data its files hold."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / BENCH / "metrics" / f"{metric}.py")

    def driver(self) -> ModuleType:
        return importlib.import_module(f"{BENCH}.drivers.{self.traffic['kind']}")

    def reference(self) -> ModuleType:
        return importlib.import_module(f"{BENCH}.reference.{self.config['tower']['kind']}")


def load(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a workload reports: those
    that list it, and an end-to-end metric with no list (``setup_s``)."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_json(root / cfg_entry["file"]),
        traffic=_json(root / BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / BENCH / "limits" / f"{workload}.json"),
        end_to_end=metrics_of(bench, workload, "end_to_end"),
        per_layer=metrics_of(bench, workload, "per_layer"),
        root=root,
    )


def problems(bench: dict, root: Path) -> list[str]:
    """What in ``bench`` breaks the contract's rules of form (names, units,
    keys, files, each metric's cells against its end-to-end metric's)."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
    for p in bench["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not (1 <= int(bench["run_seconds"]) <= 51):
        out.append("run_seconds")
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS)):
        for e in bench[group]:
            if set(e) != keys:
                out.append(f"{group} {e.get('name')}: keys {sorted(e)}")
    for e in bench["end_to_end"]:
        if not set(e) - {"workloads"} == E2E_KEYS:
            out.append(f"end_to_end {e.get('name')}: keys {sorted(e)}")
        if not (0 < e["bound"] <= 0.25):
            out.append(f"end_to_end {e['name']}: bound")
        if e["source"] not in ("host_clock", "device_trace"):
            out.append(f"end_to_end {e['name']}: source")
    for e in bench["per_layer"]:
        if set(e) != LAYER_KEYS:
            out.append(f"per_layer {e.get('name')}: keys {sorted(e)}")
    if out:  # what follows reads the keys
        return out
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in bench[group]:
            if not NAME.match(e["name"]):
                out.append(f"{group} name {e['name']!r}")
            if e["name"] in seen:
                out.append(f"{group}: {e['name']} twice")
            seen.add(e["name"])
    for e in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(e["unit"]) or e["better"] not in ("lower", "higher"):
            out.append(f"{e['name']}: unit or better")
    for c in bench["configs"]:
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"reduced key {k!r}")
        if not (root / c["file"]).is_file() or not c["file"].startswith(BENCH + "/"):
            out.append(f"config file {c['file']}")
        for text in (c["why"], c["source"]):
            if not (1 <= len(text) <= 200) or "\n" in text or "\t" in text:
                out.append(f"config {c['name']}: text")
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    pairs = set()
    for w in bench["workloads"]:
        if w["config"] not in configs or w["chips"] not in (1, 4) or not NAME.match(w["traffic"]):
            out.append(f"workload {w['name']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        if not (1 <= len(w["why"]) <= 200) or "\n" in w["why"]:
            out.append(f"workload {w['name']}: why")
    for c in configs:
        if not any(w["config"] == c for w in bench["workloads"]):
            out.append(f"config {c} used by no cell")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["per_layer"]:
        target = e2e.get(m["moves"])
        if target is None:
            out.append(f"{m['name']}: moves {m['moves']!r}")
            continue
        reported = set(target.get("workloads", cells))
        for w in m["workloads"]:
            if w not in cells or w not in reported:
                out.append(f"{m['name']}: cell {w} does not report {m['moves']}")
        if "\n" in m["layer"] or not (1 <= len(m["layer"]) <= 200):
            out.append(f"{m['name']}: layer")
    for w in cells:
        rep = [m["name"] for m in metrics_of(bench, w, "end_to_end")]
        if "setup_s" not in rep or len(rep) < 2 or not metrics_of(bench, w, "per_layer"):
            out.append(f"workload {w}: metrics {rep}")
    return out
