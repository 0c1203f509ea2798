"""The readings that the encode-then-rank cell's limits are set from,
besides the program's own: the controls and the faults, at the cell's own
size.

    python3 portbench/tools/nvembed_control.py --workload nvembed2-latent4096.encode_eval --seeds 11,12 [--out FILE]

For each seed it makes the cell's inputs as a run does (the encoder's
bfloat16 weights, the tower's, the titles and behaviours; no program is
built) and reads the cell's own numbers with the plain reference, computed
another way, in the program's place:

- ``embed_gap`` against the float32 reference over the sampled rows of both
  tables, of ``mantissa3`` (every product's operands rounded to 3 mantissa
  bits, below the configuration's bfloat16), ``causal`` (the causal mask
  put back), ``instruction_pooled`` (the query rows' pool with the
  instruction in it), ``last_layer_dropped`` (the backbone's last layer
  left out) and ``mean_head`` (the latent head replaced by the masked mean);
- ``score_gap`` and ``metric_gap`` of the tower over random unit tables
  from the seed (the tower's precision does not hang on what its tables
  hold): ``tower_tf32`` and ``tower_bfloat16`` (the reference tower in TF32
  and in bfloat16 against the float32 one), ``reduced_in_bfloat16`` (the
  MIND metrics of the scores rounded to bfloat16: the reduction's control,
  apart from the scores) and ``altered`` (the first impression's scores
  turned upside down).

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

from portbench import spec, weights  # noqa: E402
from portbench.drivers import encode_eval  # noqa: E402
from portbench.reference import metrics as ref_metrics  # noqa: E402
from portbench.reference import nvembed  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402


def encoder_controls(drv) -> dict:
    """Each control of the encoder and its ``embed_gap``."""
    layers = drv.hf["text_config"]["num_hidden_layers"]
    controls = {
        "mantissa3": {"prod": nvembed.Products(3)},
        "causal": {"causal": True},
        "instruction_pooled": {"pool_instruction": True},
        "last_layer_dropped": {"layers": layers - 1},
        "mean_head": {"latent_head": False},
    }
    want = drv.reference_samples()
    out = {}
    for name, control in controls.items():
        got = drv.reference_samples(**control)
        gap = max(float(torch.linalg.vector_norm(g - w, dim=-1).max()) for (_, g), (_, w) in zip(got, want))
        out[name] = {"embed_gap": gap}
    return out


def tower_controls(drv) -> dict:
    """``score_gap`` and ``metric_gap`` of the tower's controls over random
    unit tables."""
    dev, cfg = drv.device, drv.cfg
    dim = cfg["tower"]["reduced_dim"]
    query = weights.news_table(cfg["news"], dim, weights.device_generator(drv.seed, 8, dev), dev)
    passage = weights.news_table(cfg["news"], dim, weights.device_generator(drv.seed, 9, dev), dev)
    data, limits = drv._data(), drv.cell.limits
    ref = drv.rank_reference(query, passage, Precision("float32"))

    def reading(scores, metrics):
        rows = encode_eval.eval_driver.numbers(scores, [metrics], ref["scores"], data, limits)
        return {c["name"]: c["value"] for c in rows}

    out = {}
    for mode in ("tf32", "bfloat16"):
        low = drv.rank_reference(query, passage, Precision(mode))
        out[f"tower_{mode}"] = reading(low["scores"], low["metrics"])
    rounded = torch.tensor(ref["scores"], dtype=torch.float32).to(torch.bfloat16).double().numpy()
    out["reduced_in_bfloat16"] = reading(ref["scores"], ref_metrics.mind_metrics(rounded, data.labels, data.imp_lens))
    altered = ref["scores"].copy()
    altered[: data.imp_lens[0]] *= -1.0
    out["altered"] = reading(altered, ref_metrics.mind_metrics(altered, data.labels, data.imp_lens))
    return out


def run(root: Path, workload: str, seeds: list, device: str = "cuda") -> list[dict]:
    cell = spec.cell(root, workload)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = encode_eval.Driver(cell, seed, 0.0, device, False)
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
