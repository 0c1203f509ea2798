"""The control and the faults come out not correct against each cell's
limits: the reference computed in TF32 and in bfloat16 in the program's
place, and each step on half its batch (training) or the metrics over half
the impressions (the eval), at every width of the cell and fewer rows, on
the CPU. ``tools/control.py`` reads the same at the cells' own size on the
card (``test_the_control_fails_at_the_cells_own_size``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import spec
from portbench.tests import tiny
from portbench.tools import control

CELLS = [w["name"] for w in spec.load(tiny.ROOT)["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.reduced_root(tmp_path_factory.mktemp("control"), {"train_rows": 200, "dev_rows": 96})


def _fails(row: dict, limits: dict) -> bool:
    return any(row[k] > limits[k] for k in row if k in limits) or row.get("wrong_answers", 0) > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_faults_fail_on_the_cpu(root, workload):
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rows = control.run(root, workload, [2**31 + 77], seconds=0.2, device="cpu")
    finally:
        torch.set_num_threads(before)
    limits = spec.cell(root, workload).limits
    failed = {r["reading"] for r in rows if _fails(r, limits)}
    assert "tf32" in failed and "bfloat16" in failed, rows
    assert {"half_batch", "altered"} & failed, rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at a cell's own size runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, workload, tmp_path):
    out = tmp_path / "control.jsonl"
    subprocess.run(
        [sys.executable, str(tiny.ROOT / "portbench" / "tools" / "control.py"), "--workload", workload,
         "--seeds", "2147483711,2147483712,2147483713", "--out", str(out)],
        check=True, timeout=1200,
    )
    limits = spec.cell(tiny.ROOT, workload).limits
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    for seed in {r["seed"] for r in rows}:
        assert any(_fails(r, limits) for r in rows if r["seed"] == seed and r["reading"] == "tf32"), rows
