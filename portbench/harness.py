"""One run of one cell: set-up, the measured window, with ``trace`` a
traced window after it, the device's figures, then the comparison with the
plain reference once the program's state is freed."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from pathlib import Path

import torch

from portbench import check, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "news_recommendation_project_v2_tpu")


class NoChip(RuntimeError):
    pass


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads: the cell, the driver's
    counters and spans, and the traced window's device trace (``None``
    without ``--trace 1`` or without a device)."""

    cell: spec.Cell
    counters: dict
    trace: object

    @property
    def tower(self) -> dict:
        return self.cell.config["tower"]

    @property
    def dtype(self) -> str:
        return self.tower["compute_dtype"]

    @property
    def kind(self) -> str:
        return self.counters["kind"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> dict:
    cell = spec.cell(root, workload)
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoChip(f"{workload} needs {cell.chips} CUDA device(s); found {n}")
    driver = cell.driver().Driver(cell, seed, seconds, device, trace)
    driver.setup()
    # What set-up made lives to the end; keep the collector from walking it
    # again and again inside the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    e2e, attempted, failed = driver.window(seconds)
    traces: list = []
    if trace:
        driver.traced(traces)
    gc.unfreeze()
    counters = driver.readings()
    cuda = device == "cuda"
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
    }
    tr = traces[0] if traces else None
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    driver.release()
    checks = driver.check()
    metrics = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        r = Readings(cell, counters, tr)
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(r)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": check.passed(checks) and failed == 0,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and tr is not None:
        out["breakdown"] = tr.breakdown()
    out["unit_s"] = getattr(driver, "unit_s", [])
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out
