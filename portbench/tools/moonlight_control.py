"""The readings that the Moonlight encode-then-rank cell's limits are set
from, besides the program's own: the controls, at the cell's own size.

    python3 portbench/tools/moonlight_control.py --workload moonlight16b-latent2048.moe_encode_eval --seeds 11,12 [--out FILE]

For each seed it makes the cell's inputs as a run does (the encoder's
bfloat16 weights, the tower's, the titles and behaviours; no program is
built) and reads the cell's own numbers with the plain reference, computed
another way, in the program's place:

- ``embed_gap`` and ``route_mismatch`` against the float32 reference over
  the sampled rows of both tables, of each of ``CONTROLS``: every product's
  operands rounded to 3 mantissa bits (below the configuration's bfloat16),
  5 experts a token in place of 6, the selection bias left out, the
  weights not renormalised, not scaled by the routed scaling factor, the
  shared experts left out, the rotary dims not de-interleaved, the latent's
  RMSNorm skipped, attention without the causal mask, the last layer left
  out;
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
from portbench.drivers import moe_encode_eval  # noqa: E402
from portbench.reference.nvembed import Products  # noqa: E402
from portbench.tools.nvembed_control import tower_controls  # noqa: E402

CONTROLS = {
    "mantissa3": {"prod": Products(3)},
    "top5": {"top_k": 5},
    "bias_ignored": {"bias": False},
    "unnormalised": {"renormalize": False},
    "unscaled": {"scale": False},
    "shared_left_out": {"shared": False},
    "rope_interleaved": {"interleaved": False},
    "kv_norm_skipped": {"kv_norm": False},
    "bidirectional": {"causal": False},
    "last_layer_dropped": {},  # the layer count is the cell's own: see encoder_controls
}


def encoder_controls(drv) -> dict:
    """Each control of the encoder and its ``embed_gap`` and
    ``route_mismatch``, as the cell's check reads a program's: against the
    float32 reference that applies the control's picks."""
    out = {}
    for name, control in CONTROLS.items():
        if name == "last_layer_dropped":
            control = {"layers": drv.hf["num_hidden_layers"] - 1}
        routes: list = []
        got = drv.reference_samples(routes=routes, **control)
        want_routes: list = []
        want = drv.reference_samples(routes=want_routes, forced=routes)
        gap = max(float(torch.linalg.vector_norm(g - w, dim=-1).max()) for (_, g), (_, w) in zip(got, want))
        out[name] = {"embed_gap": gap, "route_mismatch": moe_encode_eval.route_mismatch(routes, want_routes)}
    return out


def run(root: Path, workload: str, seeds: list, device: str = "cuda") -> list[dict]:
    cell = spec.cell(root, workload)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = moe_encode_eval.Driver(cell, seed, 0.0, device, False)
        drv.titles, drv.instruction = drv.texts()
        drv.inputs()
        readings = {**encoder_controls(drv), **tower_controls(drv)}
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
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = run(ROOT, args.workload, [int(s) for s in args.seeds.split(",")], args.device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
