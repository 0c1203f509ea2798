"""The readings that the Kimi-Linear article encode-then-rank cell's limits
are set from, besides the program's own: the controls, at the cell's own
size.

    python3 portbench/tools/kimi_linear_control.py --workload kimilinear48b-latent2304.article_encode_eval --seeds 11,12 [--controls a,b] [--out FILE]

For each seed it makes the cell's inputs as a run does (this card's
bfloat16 weights, the tower's, the articles and behaviours; no program is
built) and reads the cell's own numbers with the plain reference, computed
another way, in the program's place:

- ``embed_gap`` and ``route_mismatch`` against the float32 reference over
  the sampled rows of both tables, of each of ``CONTROLS``: every product's
  operands rounded to 3 mantissa bits (below the configuration's bfloat16),
  one decay a head (the mean of its channels') in place of one a channel,
  beta set to 1, q and k not L2-normalised, the short convs skipped, the
  output gate skipped, the state set to 0 every 1,024 tokens, the MLA's 64
  rotary dims rotated as Moonlight's, all 256 experts computed (the other
  card's 128 drawn from the seed);
- ``score_gap`` and ``metric_gap`` of the tower over random unit tables
  (``nvembed_control.tower_controls``).

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

import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.drivers import article_encode_eval, moe_encode_eval  # noqa: E402
from portbench.reference import kimi_linear  # noqa: E402
from portbench.reference.nvembed import Products  # noqa: E402
from portbench.tools.nvembed_control import tower_controls  # noqa: E402

CONTROLS = {
    "mantissa3": {"prod": Products(3)},
    "decay_per_head": {"decay": "head"},
    "beta_one": {"beta_one": True},
    "no_l2_norm": {"l2": False},
    "convs_skipped": {"conv": False},
    "gate_skipped": {"gate": False},
    "state_reset_1024": {"reset": 1024},
    "mla_rotated": {"rotated": True},
    "all_experts": {},  # the other card's experts are the seed's: see encoder_controls
}


def encoder_controls(drv, names=None) -> dict:
    """Each control of the encoder and its ``embed_gap`` and
    ``route_mismatch``, as the cell's check reads a program's: against the
    float32 reference that applies the control's picks."""
    out = {}
    for name, control in CONTROLS.items():
        if names is not None and name not in names:
            continue
        if name == "all_experts":
            control = {"unheld": kimi_linear.unheld_experts(drv.hf, drv.held, drv.seed, drv.device)}
        routes: list = []
        got = drv.reference_samples(routes=routes, **control)
        want_routes: list = []
        want = drv.reference_samples(routes=want_routes, forced=routes)
        # A control whose recurrence diverges (q and k unnormalised) gives no finite vector: no gap is smaller.
        gap = max(float(torch.linalg.vector_norm(g - w, dim=-1).nan_to_num(float("inf")).max())
                  for (_, g), (_, w) in zip(got, want))
        out[name] = {"embed_gap": gap, "route_mismatch": moe_encode_eval.route_mismatch(routes, want_routes)}
    return out


def run(root: Path, workload: str, seeds: list, device: str = "cuda", names=None) -> list[dict]:
    cell = spec.cell(root, workload)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = article_encode_eval.Driver(cell, seed, 0.0, device, False)
        drv.titles, drv.instruction = drv.texts()
        drv.inputs()
        readings = {**encoder_controls(drv, names), **tower_controls(drv)}
        for kind, values in readings.items():
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
    p.add_argument("--controls", default=None, help="a comma-separated subset of CONTROLS (default: all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    names = None if args.controls is None else set(args.controls.split(","))
    rows = run(ROOT, args.workload, [int(s) for s in args.seeds.split(",")], args.device, names)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
