"""``BENCHMARK.json`` against the contract's rules of form, and every file it
leads to."""

from __future__ import annotations

import json

import pytest

from portbench import spec
from portbench.tests.tiny import ROOT

BENCH = spec.load(ROOT)


def test_benchmark_json_keeps_the_rules_of_form():
    assert spec.problems(BENCH, ROOT) == []


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_names_and_units_use_the_allowed_characters(metric):
    assert spec.NAME.match(metric["name"])
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        assert cell in e2e[metric["moves"]]["workloads"]
        assert metric in spec.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = spec.cell(ROOT, workload)
    assert cell.chips == 1
    assert cell.driver().Driver
    assert cell.reference().param_shapes(cell.config["tower"])
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(cell.limits) >= {"loss_gap"} or set(cell.limits) >= {"metric_gap"} or "score_gap" in cell.limits


def test_the_command_names_no_file_outside_paths():
    for word in BENCH["command"][1:]:
        assert word.startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_configuration_names_no_width_as_reduced():
    widths = ("dim", "hidden", "intermediate", "latent", "head", "rank", "expert", "mult", "size")
    for c in BENCH["configs"]:
        assert not [k for k in c["reduced"] if any(w in k for w in widths)]
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert cfg[k] < cfg["published"][k]
