"""The readings that the limits of ``correct`` are set from, besides the
program's own: the control and the faults, at a cell's own size.

    python3 portbench/tools/control.py --workload <cell> --seeds 11,12,13 [--out FILE]

For each seed it makes the cell's inputs as a run does (no program is
built) and puts the plain reference, computed another way, in the
program's place, then compares it with the float32 reference by the cell's
own numbers:

- ``tf32`` and ``bfloat16``: the reference with its products in TF32 or in
  bfloat16 (the control: the precision below the configuration's float32);
- ``half_batch`` (training): each step on the first half of its pairs, the
  mean taken over them; (the eval) the metrics over the first half of the
  impressions;
- ``reduced_in_bfloat16`` (the eval): the metrics of the scores rounded to
  bfloat16, the control of the reduction apart from the scores;
- ``altered`` (the eval): the first impression's scores turned upside down.

Prints one JSON line per seed and reading; ``--out`` also writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402

LOWER = ("tf32", "bfloat16")


def _values(checks: list) -> dict:
    return {c["name"]: c["value"] for c in checks}


def train_readings(drv) -> dict:
    mod = sys.modules[type(drv).__module__]
    ref = drv.reference(Precision("float32"))
    out = {m: _values(mod.numbers(drv.reference(Precision(m)), ref, drv.init, drv.cell.limits)) for m in LOWER}
    half = drv.reference(Precision("float32"), pair_filter=lambda n: np.arange(n) < n // 2)
    out["half_batch"] = _values(mod.numbers(half, ref, drv.init, drv.cell.limits))
    return out


def eval_readings(drv) -> dict:
    mod = sys.modules[type(drv).__module__]
    data = drv._data()
    ref = drv.reference(Precision("float32"))

    def reading(scores, results):
        return _values(mod.numbers(scores, results, ref["scores"], data, drv.cell.limits))

    out = {}
    for m in LOWER:
        low = drv.reference(Precision(m))
        out[m] = reading(low["scores"], [low["metrics"]])
    rows = np.arange(drv.cfg[drv.traffic["rows"]] // 2)
    out["half_batch"] = reading(ref["scores"], [drv.reference(Precision("float32"), rows)["metrics"]])
    rounded = torch.tensor(ref["scores"], dtype=torch.float32).to(torch.bfloat16).double().numpy()
    out["reduced_in_bfloat16"] = reading(ref["scores"], [mod.ref_metrics.mind_metrics(rounded, data.labels, data.imp_lens)])
    altered = ref["scores"].copy()
    altered[: data.imp_lens[0]] *= -1.0
    out["altered"] = reading(altered, [mod.ref_metrics.mind_metrics(altered, data.labels, data.imp_lens)])
    return out


READINGS = {"train": train_readings, "eval": eval_readings}


def run(root: Path, workload: str, seeds: list, seconds=None, device: str = "cuda") -> list[dict]:
    cell = spec.cell(root, workload)
    seconds = seconds or spec.load(root)["run_seconds"]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = cell.driver().Driver(cell, seed, seconds, device, False)
        drv.inputs()
        for kind, values in READINGS[cell.traffic["kind"]](drv).items():
            row = {"workload": workload, "seed": seed, "reading": kind, **values}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del drv
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window; run_seconds")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = run(ROOT, args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
