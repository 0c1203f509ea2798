#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or a few each, exit code non-zero on any failure:
  1. device:  the card's name and power limit (nvidia-smi).
  2. build:   nvcc of every ops/csrc/*.cu, in parallel, into build/kernels/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
              serving shapes and at D=1536 for the GEGLU, in float32 and
              bfloat16, and the attention at the flat eval's
              [1, 8, 131072, 512] in float32, with the time of the kernel, of
              the plain version, of one PyTorch library call that computes
              the same function (a yardstick the port never calls), the least
              time the card could take (the bound) and the kernel's share of
              it. Each time is taken twice (ops/timing.py): as calls back to
              back, host costs included (ms, plain_ms, library_ms), and as
              the device time of calls replayed from a CUDA graph
              (device_ms, plain_device_ms, library_device_ms). A bfloat16 GEGLU
              is held to its tolerance beyond the one-unit roundings of gated
              values that lie at a bfloat16 tie (geglu_tie_allowance).
  4. serve:   a full-width latent tower (D=1024, 64 latents, 8 heads x 512)
              with random weights from a numpy seed, saved as a state_dict,
              and a 65,238 x 1024 news table (MIND-small's news count) saved
              as an id-keyed dump, loaded through cli.serve.build_ranker;
              rank, retrieve(k=10), a rank_batch of 64 MIND-like requests and
              one HTTP POST /rank, with every launch count set to 0 just
              before and read just after. Every kernel must have launched;
              4 requests must match the same ranker built on the CPU.
  5. main path: each kernel against its plain version again, at every shape
              the served path launched it at (float32), with the times, the
              bound and the share of bound per shape and summed over those
              launches.
  6. flat eval: FlatEvalPlan.score and .metrics (with a DeviceMetricsPlan)
              over bench.py's MIND-small-scale workload (50,000 rows;
              build_workload copied here) at full width, in float32 and in bfloat16
              as bench.py runs it; the chunk estimate_flat_chunk picks, the
              peak memory, each kernel's launches and shapes (counts set to
              0 just before one metrics run and read just after),
              impressions/s of three timed runs of each, a profiled metrics
              run and its host syncs. Checks: 1 both kernels launched; 2
              about 64 rows centred on the float32 chunk boundaries, some
              straddling two chunks, match the same plan on the CPU (1e-4);
              3 score runs are bit-identical; 4 metrics equal
              DeviceMetricsPlan.compute of the scores (1e-6); 5 the same
              rows match the tower's padded, masked call (1e-5); 6 bfloat16
              within a norm-relative 3e-2 of
              float32. Then each kernel against its plain version at every
              shape the flat eval launched it at, as in phase 5 (the plain
              versions on pieces of at most PIECE_ROWS rows).
The line before the last but one holds the kernels' record as JSON, one
entry per kernel and path ("path": "serve" from phase 5, "flat_eval" from
phase 6); the line before the last the card's name and power limit; the last
line is {"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from news_recommendation_project_v2_torch.cli.serve import build_ranker, make_server  # noqa: E402
from news_recommendation_project_v2_torch.config import TowerConfig  # noqa: E402
from news_recommendation_project_v2_torch.data.grouping import lengths_to_offsets  # noqa: E402
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan  # noqa: E402
from news_recommendation_project_v2_torch.models import build_tower  # noqa: E402
from news_recommendation_project_v2_torch.models.convert import (  # noqa: E402
    latent_state_dict_from_jax,
    random_latent_params,
)
from news_recommendation_project_v2_torch.ops import _build  # noqa: E402
from news_recommendation_project_v2_torch.ops.encode import save_embeddings  # noqa: E402
from news_recommendation_project_v2_torch.ops.geglu import geglu, reference_geglu  # noqa: E402
from news_recommendation_project_v2_torch.ops.latent_attention import (  # noqa: E402
    latent_attention,
    reference_attention,
)
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan  # noqa: E402
from news_recommendation_project_v2_torch.ops.timing import count_syncs, cuda_ms, graph_ms  # noqa: E402
from news_recommendation_project_v2_torch.utils.memory import (  # noqa: E402
    estimate_flat_chunk,
    flat_token_bytes,
)

NUM_NEWS, DIM = 65_238, 1024
N_REQUESTS = 64
FLAT_ROWS = 50_000  # with-history impression rows of the flat eval, as in bench.py
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense) and device-memory
# bandwidth. bfloat16 on the tensor cores. float32: the card computes
# float32-accurate products fastest as 3xTF32 on the tensor cores (three TF32
# products each, 495 / 3 = 165 TFLOP/s), not on the CUDA cores (67 TFLOP/s),
# so 165 is the least time the work can take, whichever kernel does it.
PEAK_FLOPS = {torch.float32: 165e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# Tolerances of kernel vs plain version on the same inputs. Both compute
# float32-accurate products (the GEGLU as 3xTF32) summed in float32, and
# differ in summation order: a bfloat16 output may then round one unit apart
# (2^-8 relative), a float32 GEGLU sums up to 6,144 + 1,536 products.
TOL = {
    ("latent_attention", torch.float32): 1e-5,
    ("latent_attention", torch.bfloat16): 2**-8 * 4.0,
    ("geglu", torch.float32): 1e-4,
    ("geglu", torch.bfloat16): 1e-3,
}
def log(msg: str) -> None:
    print(msg, flush=True)


def attention_inputs(shape, dtype, gen):
    b, h, l, n, dh = shape
    return tuple(
        torch.randn(*s, device="cuda", generator=gen).to(dtype)
        for s in ((b, h, l, dh), (h, n, dh), (h, n, dh))
    )


def attention_work(shape, es: int) -> tuple[float, float]:
    """(operations, bytes): q read and o written once, k and v read once."""
    b, h, l, n, dh = shape
    return 4.0 * b * h * l * n * dh, (2.0 * b * h * l * dh + 2.0 * h * n * dh) * es


def attention_library(q, k, v):
    b, h, _, dh = q.shape
    n = k.shape[1]
    return F.scaled_dot_product_attention(q, k.expand(b, h, n, dh), v.expand(b, h, n, dh))


def geglu_inputs(shape, dtype, gen):
    c, d, f = shape
    scales = ((c, d), 1.0), ((2 * f, d), d**-0.5), ((2 * f,), 0.02), ((d, f), f**-0.5), ((d,), 0.02)
    return tuple(
        (torch.randn(*s, device="cuda", generator=gen) * sc).to(dtype) for s, sc in scales
    )


def geglu_work(shape, es: int) -> tuple[float, float]:
    """(operations, bytes): x, both weights and biases read once, the
    float32 y written once."""
    c, d, f = shape
    return 6.0 * c * d * f, (c * d + 3.0 * d * f + 2.0 * f + d) * es + 4.0 * c * d


# A float32 gated product u within this relative distance of a bfloat16
# rounding tie may round either way in two float32-accurate computations:
# the plain version's own float32 sums differ from exact ones by about 2^-20.
TIE = 2.0**-18


def geglu_tie_allowance(x, w_in, b_in, w_out, b_out) -> tuple[torch.Tensor, float]:
    """In bfloat16 the kernel and the plain version each round u to bfloat16
    after float32 sums taken in other orders, so a u next to a rounding tie
    may round one bfloat16 unit apart, and moves y[m, n] by that unit times
    |W_out[n, f]|. Per output, the sum of that over the u of its row that lie
    within TIE of a tie; and the share of such u."""
    h, g = F.linear(x.float(), w_in.float(), b_in.float()).chunk(2, dim=-1)
    u = h * F.gelu(g, approximate="tanh")
    spread = (u * (1 + TIE)).to(x.dtype).float() - (u * (1 - TIE)).to(x.dtype).float()
    return spread.abs() @ w_out.float().abs().T, (spread != 0).float().mean().item()


def geglu_library(x, w_in, b_in, w_out, b_out):
    h, g = F.linear(x, w_in, b_in).chunk(2, dim=-1)
    return F.linear(h * F.gelu(g, approximate="tanh"), w_out, b_out)


KERNELS = {
    "latent_attention": {
        "wrapper": latent_attention,
        "plain": reference_attention,
        "library": attention_library,
        "inputs": attention_inputs,
        "work": attention_work,
        "row_dim": 2,  # q's L: rows the kernel computes independently
        "label": "B={} H={} L={} N={} dh={}",
        "source": "news_recommendation_project_v2_torch/ops/csrc/latent_attention.cu",
        "replaces": "news_recommendation_project_v2_tpu/ops/pallas_attention.py:26",
    },
    "geglu": {
        "wrapper": geglu,
        "plain": reference_geglu,
        "library": geglu_library,
        "inputs": geglu_inputs,
        "work": geglu_work,
        "row_dim": 0,  # x's C
        "label": "C={} D={} F={}",
        "source": "news_recommendation_project_v2_torch/ops/csrc/geglu.cu",
        "replaces": "news_recommendation_project_v2_tpu/ops/pallas_geglu.py:29",
    },
}

# The plain versions run on pieces of at most this many rows. At the flat
# eval's chunks one call would not fit on the card beside the graph-capture
# copy (the float32 [C, 8F] GEGLU intermediate at C = 524,288 is 17 GB); the
# rows are independent, so the pieces compute the same function.
PIECE_ROWS = 1 << 17


def measure(name: str, shape: tuple, dtype, gen) -> dict:
    """One kernel against its plain version on the same inputs: the largest
    absolute difference; the times of the kernel's wrapper, of the plain
    version (over all its row pieces) and of the library call, each as calls
    back to back (host costs included: ``ms``, ``plain_ms``, ``library_ms``)
    and as device times (calls captured in a CUDA graph and replayed:
    ``device_ms``, ``plain_device_ms``, ``library_device_ms``); and the
    bound from the work's operations and bytes."""
    spec = KERNELS[name]
    args = spec["inputs"](shape, dtype, gen)
    dim = spec["row_dim"]
    n = args[0].shape[dim]
    starts = range(0, n, PIECE_ROWS)
    pieces = [(args[0].narrow(dim, a, min(PIECE_ROWS, n - a)), *args[1:]) for a in starts]
    got = spec["wrapper"](*args)
    torch.cuda.synchronize()
    err = excess = near_tie = 0.0
    err64 = [0.0, 0.0]
    for a, piece in zip(starts, pieces):
        g = got.narrow(dim, a, piece[0].shape[dim]).float()
        want = spec["plain"](*piece).float()
        diff = (g - want).abs()
        err = max(err, diff.max().item())
        if name == "geglu" and dtype == torch.bfloat16:
            allowance, share = geglu_tie_allowance(*piece)
            diff = diff - allowance
            near_tie += share * piece[0].shape[dim] / n
        excess = max(excess, diff.max().item())
        if name == "latent_attention":
            # Both against float64, to show the kernel and the plain version
            # are independent computations even where they agree to the bit.
            q, k, v = (t.double() for t in piece)
            p64 = torch.softmax(torch.einsum("bhld,hnd->bhln", q, k) * q.shape[-1] ** -0.5, -1)
            o64 = torch.einsum("bhln,hnd->bhld", p64, v)
            err64 = [max(err64[0], (g.double() - o64).abs().max().item()),
                     max(err64[1], (want.double() - o64).abs().max().item())]
            del q, p64, o64
        del g, want, diff

    def plain():
        for piece in pieces:
            spec["plain"](*piece)

    ops, nbytes = spec["work"](shape, args[0].element_size())
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    iters, reps, rounds = (20, 10, 5) if ops < 1e10 else (5, 1, 5) if ops < 1e12 else (3, 1, 2)
    r = dict(
        label=spec["label"].format(*shape),
        err=err,
        ms=cuda_ms(lambda: spec["wrapper"](*args), iters),
        plain_ms=cuda_ms(plain, iters),
        library_ms=cuda_ms(lambda: spec["library"](*args), iters),
        device_ms=graph_ms(lambda: spec["wrapper"](*args), reps, rounds),
        plain_device_ms=graph_ms(plain, reps, rounds),
        library_device_ms=graph_ms(lambda: spec["library"](*args), reps, rounds),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    if name == "latent_attention":
        r["err64"] = tuple(err64)
    tol = TOL[(name, dtype)]
    if len(pieces) > 1:
        log(f"  {name} {str(dtype)[6:]} {r['label']}: the plain version runs on {len(pieces)} pieces of rows")
    if name == "geglu" and dtype == torch.bfloat16:
        log(
            f"  {name} bfloat16 {r['label']}: {near_tie:.3%} of u within {TIE:.3g} of a bfloat16 tie; "
            f"error beyond their one-unit roundings {excess:.3g} (tol {tol:.3g})"
        )
    log(
        f"  {name} {str(dtype)[6:]} {r['label']}: max_abs_err {r['err']:.3g} (tol {tol:.3g}) "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
        f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share of bound {r['bound_ms'] / r['ms']:.1%}; "
        f"device: kernel {r['device_ms']:.4f} plain {r['plain_device_ms']:.4f} "
        f"library {r['library_device_ms']:.4f}, share of bound {r['bound_ms'] / r['device_ms']:.1%}"
    )
    if "err64" in r:
        log(f"    vs float64: kernel {r['err64'][0]:.3g}, plain {r['err64'][1]:.3g}")
    if not excess <= tol:
        raise AssertionError(f"{name} {dtype} {r['label']}: error {excess} > {tol}")
    return r


def kernel_phase(gen) -> None:
    """Every kernel vs its plain version at the serving shapes that bound the
    path's range (a single request's 16 history rows, eight short and eight
    600-long history rows, and two and four rows of the 256 and 600 history
    buckets between them; one request's 37 tokens and eight 600-token rows),
    in float32 and bfloat16, the GEGLU at D=1536, wider than a 1024 row, and
    the attention at the flat eval's [1, 8, 131072, 512] in float32."""
    cases = [
        ("latent_attention", (b, 8, l, 64, 512))
        for b, l in ((1, 16), (8, 16), (2, 256), (4, 256), (2, 600), (4, 600), (8, 600))
    ]
    cases += [("geglu", (c, DIM, 4 * DIM)) for c in (37, 4800)]
    cases += [("geglu", (37, 1536, 4 * 1536))]
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for name, shape in cases:
                measure(name, shape, dtype, gen)
        measure("latent_attention", (1, 8, 131072, 64, 512), torch.float32, gen)


TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms", "library_device_ms")


def main_path_phase(shapes: dict, gen, path: str = "main path") -> dict[str, dict]:
    """Every kernel vs its plain version at each (shape, type) ``path``
    launched it at. Per kernel, the times and the bound are summed over the
    path's launches: each shape's figure times the number of launches at
    that shape."""
    record = {}
    with torch.no_grad():
        for name, counts in shapes.items():
            keys = sorted(counts, key=lambda k: (str(k[1]), k[0]))
            rows = [(counts[k], measure(name, k[0], k[1], gen)) for k in keys]
            by = {"operations": 0.0, "bytes": 0.0}
            for n, r in rows:
                by[r["bound_by"]] += n * r["bound_ms"]
            types = "+".join(sorted({str(k[1])[6:] for k in keys}))
            record[name] = dict(
                label=f"{path}: {len(rows)} shapes, {sum(n for n, _ in rows)} launches, {types}",
                err=max(r["err"] for _, r in rows),
                **{k: sum(n * r[k] for n, r in rows) for k in (*TIMES, "bound_ms")},
                bound_by=max(by, key=by.get),
            )
            r = record[name]
            log(
                f"  {name} summed over the {path}'s launches: kernel_ms {r['ms']:.4f} "
                f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share of bound {r['bound_ms'] / r['ms']:.1%}; "
                f"device: kernel {r['device_ms']:.4f} plain {r['plain_device_ms']:.4f} "
                f"library {r['library_device_ms']:.4f}, share of bound {r['bound_ms'] / r['device_ms']:.1%}"
            )
    return record


def build_workload(rng: np.random.Generator, num_rows: int = FLAT_ROWS, num_news: int = NUM_NEWS):
    """bench.py's MIND-small-scale eval workload, draw for draw (a CPU test
    holds the two equal): geometric histories (mean 33, capped at 600),
    Poisson(37) candidates clipped to 2-300, click labels with at least one
    positive and one negative per impression. Returns (hist_lens, imp_lens,
    hist_rev, cand_rev, cand_row, labels)."""
    hist_lens = np.minimum(rng.geometric(1.0 / 33, size=num_rows), 600).astype(np.int32)
    imp_lens = np.clip(rng.poisson(37, size=num_rows), 2, 300).astype(np.int32)
    hist_rev = rng.integers(0, num_news, size=int(hist_lens.sum())).astype(np.int32)
    cand_rev = rng.integers(0, num_news, size=int(imp_lens.sum())).astype(np.int32)
    cand_row = np.repeat(np.arange(num_rows, dtype=np.int32), imp_lens)
    labels = (rng.random(len(cand_rev)) < 0.2).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(imp_lens)])
    labels[offsets[:-1]] = 1.0
    labels[offsets[1:] - 1] = 0.0
    return hist_lens, imp_lens, hist_rev, cand_rev, cand_row, labels


def mind_like_requests(rng: np.random.Generator, ids: list[str], n: int) -> list:
    """Geometric histories (mean 29, capped at 600), 10-90 candidates."""
    out = []
    for _ in range(n):
        h = int(np.clip(rng.geometric(1 / 29.0), 1, 600))
        c = int(rng.integers(10, 90))
        out.append(
            (
                [ids[j] for j in rng.integers(0, len(ids), h)],
                [ids[j] for j in rng.integers(0, len(ids), c)],
            )
        )
    return out


def check_ranked(ranked, candidates) -> None:
    if sorted(c for c, _ in ranked) != sorted(candidates):
        raise AssertionError("the ranked ids are not the request's candidates")
    scores = np.array([s for _, s in ranked])
    if not (np.isfinite(scores).all() and (np.diff(scores) <= 0).all()):
        raise AssertionError(f"scores not finite and descending: {scores}")


def profile_call(label: str, fn, top: int = 10) -> dict:
    """Device time by kernel for one call of ``fn``, and the device's busy
    share of the wall time (both under the profiler, which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    log(
        f"  profile of one {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}); device time by kernel:"
    )
    for ms, count, key in rows[:top]:
        log(f"    {ms:9.3f} ms {count:5d}x  {key[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy)


def serve_phase(device: str, work_dir: Path, num_news: int, tower_config: TowerConfig) -> dict:
    """Drive the port's serving path as a user would. Returns the launch
    counts (in all and per path) and the launches by shape, requests/s and
    the CPU comparison's largest score difference."""
    rng = np.random.default_rng(SEED)
    ckpt = work_dir / "tower.pt"
    torch.save(latent_state_dict_from_jax(random_latent_params(rng, tower_config)), ckpt)
    dim = tower_config.reduced_dim
    emb = rng.standard_normal((num_news, dim), dtype=np.float32) * 0.05
    ids = [f"N{i}" for i in range(num_news)]
    save_embeddings(work_dir / "emb", "MINDsmall_dev", emb, news_ids=np.array(ids))
    del emb
    t0 = time.perf_counter()
    ranker = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, tower_config, device=device)
    log(f"  build_ranker: {time.perf_counter() - t0:.2f}s ({num_news} x {dim} table)")
    requests = mind_like_requests(rng, ids, N_REQUESTS)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    server = make_server(ranker, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:

        def http_rank():
            hist, cands = requests[1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/rank",
                data=json.dumps({"history": hist, "candidates": cands}).encode(),
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=300) as resp:
                ranked = json.loads(resp.read())["ranked"]
            check_ranked([(c, s) for c, s in ranked], cands)
            return ranked

        paths = {
            "rank": lambda: check_ranked(ranker.rank(*requests[0]), requests[0][1]),
            "retrieve": lambda: ranker.retrieve(requests[0][0], k=10),
            "rank_batch": lambda: ranker.rank_batch(requests),
            "http_rank": http_rank,
        }
        launches, results = {}, {}
        for spec in KERNELS.values():
            spec["wrapper"].launches = 0
            spec["wrapper"].shapes.clear()
        for path, run in paths.items():
            before = {k: v["wrapper"].launches for k, v in KERNELS.items()}
            results[path] = run()
            sync()
            launches[path] = {k: v["wrapper"].launches - before[k] for k, v in KERNELS.items()}
        total = {k: v["wrapper"].launches for k, v in KERNELS.items()}
        shapes = {k: collections.Counter(v["wrapper"].shapes) for k, v in KERNELS.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  launches per path: {json.dumps(launches)}")

    top = results["retrieve"]
    if not (len(top) == 10 and (np.diff([s for _, s in top]) <= 0).all()):
        raise AssertionError(f"retrieve(k=10) gave {top}")
    for (_, cands), ranked in zip(requests, results["rank_batch"]):
        check_ranked(ranked, cands)
    for name, n in total.items():
        if device == "cuda" and n == 0:
            raise AssertionError(f"the serving path never launched the {name} kernel")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ranker.rank_batch(requests)
        sync()
        times.append(time.perf_counter() - t0)
    rps = [N_REQUESTS / t for t in times]
    if device == "cuda":
        profile_call("rank_batch", lambda: ranker.rank_batch(requests))

    cpu = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, tower_config, device="cpu")
    diff = 0.0
    for (_, cands), got, want in zip(requests[:4], results["rank_batch"], cpu.rank_batch(requests[:4])):
        a, b = dict(got), dict(want)
        diff = max(diff, max(abs(a[c] - b[c]) for c in cands))
    return dict(launches=total, shapes=shapes, rps=rps, cpu_diff=diff)


def boundary_rows(hist_lens: np.ndarray, chunk: int, n: int = 64) -> np.ndarray:
    """About ``n`` rows, ascending, centred on the flat eval's token-chunk
    boundaries: the rows whose tokens straddle two chunks, where the pool
    carries a row's sum from one chunk into the next, and their neighbours."""
    ends = np.cumsum(hist_lens)
    cuts = np.arange(chunk, int(ends[-1]), chunk)
    if not len(cuts):
        return np.arange(min(n, len(hist_lens)))
    half = max(1, n // (2 * len(cuts)))
    mid = np.searchsorted(ends, cuts, side="right")  # the row holding token ``cut``
    return np.unique(np.clip(mid[:, None] + np.arange(-half, half), 0, len(hist_lens) - 1))


def take_rows(rows, hist_rev, hist_lens, cand_rev, imp_lens) -> tuple[tuple, np.ndarray]:
    """The flat arrays of ``rows`` alone (candidate rows numbered 0 up), and
    the positions of their candidate slots in the whole workload's."""
    h_off, c_off = lengths_to_offsets(hist_lens), lengths_to_offsets(imp_lens)
    hist = np.concatenate([np.arange(h_off[r], h_off[r + 1]) for r in rows])
    slots = np.concatenate([np.arange(c_off[r], c_off[r + 1]) for r in rows])
    cand_row = np.repeat(np.arange(len(rows)), imp_lens[rows])
    return (hist_rev[hist], hist_lens[rows], cand_rev[slots], cand_row), slots


def padded_scores(tower, emb, hist_rev, hist_lens, cand_rev, cand_row) -> np.ndarray:
    """Cosine scores through the tower's padded, masked call, as the serving
    path makes it: histories gathered into [rows, max_len, D] with zero pad
    rows and a mask, the tower's own pool, the cosine with 1e-8 clamps."""
    n, width = len(hist_lens), int(hist_lens.max())
    ends = np.cumsum(hist_lens)
    idx = np.zeros((n, width), np.int64)
    mask = np.zeros((n, width), np.float32)
    for r in range(n):
        idx[r, : hist_lens[r]] = hist_rev[ends[r] - hist_lens[r] : ends[r]]
        mask[r, : hist_lens[r]] = 1.0
    idx_t, mask_t = torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda()
    with torch.inference_mode():
        user = tower(emb[idx_t] * mask_t[..., None], mask_t).float()
        u = user[torch.from_numpy(cand_row.astype(np.int64)).cuda()]
        c = emb[torch.from_numpy(cand_rev.astype(np.int64)).cuda()]
        nu = torch.linalg.vector_norm(u, dim=-1).clamp_min(1e-8)
        nc = torch.linalg.vector_norm(c, dim=-1).clamp_min(1e-8)
        return ((u * c).sum(-1) / (nu * nc)).cpu().numpy()


def flat_eval_run(dtype, state: dict, emb: torch.Tensor, mplan, work: tuple) -> dict:
    """One type's flat eval over the whole workload, as bench.py runs it:
    the main-path run (launch counts set to 0 just before and read just
    after, the peak memory), three timed ``score`` and ``metrics`` runs
    after a warm-up, a profiled ``metrics`` run, a count of its host syncs,
    and the checks of this type."""
    hist_lens, imp_lens, hist_rev, cand_rev, cand_row, _ = work
    kind = str(dtype)[6:]
    cfg = TowerConfig(kind="latent", compute_dtype=kind)
    tower = build_tower(cfg)
    tower.load_state_dict(state)
    tower = tower.to("cuda", dtype)  # bfloat16: every parameter, as bench.py casts them
    query = emb.to(dtype)
    chunk = estimate_flat_chunk(cfg, device="cuda")
    t0 = time.perf_counter()
    plan = FlatEvalPlan(hist_rev, hist_lens, cand_rev, cand_row, chunk_tokens=chunk)
    n_chunks = len(plan.history.chunks)
    log(
        f"  {kind}: estimate_flat_chunk picked {chunk:,} tokens ({n_chunks} chunks, "
        f"{n_chunks * chunk:,} token rows with the last chunk's pad); FlatEvalPlan built in "
        f"{time.perf_counter() - t0:.2f}s"
    )

    def metrics():
        return plan.metrics(tower, emb, mplan, query_news_emb=query)

    def score():
        return plan.score(tower, emb, query_news_emb=query)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
        spec["wrapper"].shapes.clear()
    t0 = time.perf_counter()
    first = metrics()
    first_s = time.perf_counter() - t0
    launches = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    shapes = {k: collections.Counter({(s, dtype): n for s, n in v["wrapper"].shapes.items()})
              for k, v in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    model = chunk * flat_token_bytes(cfg)
    log(
        f"  {kind}: main-path metrics run {first_s:.2f}s (first call), {first}; launches "
        f"{json.dumps(launches)}, shapes {dict((k, {str(s[0]): n for s, n in c.items()}) for k, c in shapes.items())}"
    )
    log(
        f"  {kind}: peak memory above the tables and plans {peak / 1e9:.3f} GB = {peak / chunk:,.0f} bytes "
        f"a chunk token; the memory model's share {model / 1e9:.3f} GB ({flat_token_bytes(cfg):,} bytes a "
        f"token), its budget a quarter of {total / 1e9:.3f} GB"
    )
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"check 1: the {kind} flat eval never launched the {name} kernel")

    score()
    score_s, scores = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        scores.append(score())
        score_s.append(time.perf_counter() - t0)
    metrics_s, results = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        results.append(metrics())
        metrics_s.append(time.perf_counter() - t0)
    ips = [FLAT_ROWS / s for s in score_s], [FLAT_ROWS / s for s in metrics_s]
    log(
        f"  {kind}: score runs {['%.3f' % s for s in score_s]} s, impressions/s {['%.0f' % r for r in ips[0]]}; "
        f"metrics runs {['%.3f' % s for s in metrics_s]} s, impressions/s {['%.0f' % r for r in ips[1]]}"
    )
    prof = profile_call(f"{kind} FlatEvalPlan.metrics", metrics, top=14)
    syncs = count_syncs(metrics)
    log(f"  {kind}: host syncs in one metrics call: {syncs} (want 1)")
    if syncs != 1:
        raise AssertionError(f"the {kind} metrics call synced {syncs} times")

    if not (scores[0].shape == (len(cand_rev),) and np.isfinite(scores[0]).all()):
        raise AssertionError(f"{kind} scores: shape {scores[0].shape}, finite {np.isfinite(scores[0]).all()}")
    same = all(s.tobytes() == scores[0].tobytes() for s in scores[1:])
    log(f"  check 3 ({kind}): three score runs bit-identical: {same}")
    if not same:
        raise AssertionError(f"check 3: two {kind} score runs differ")
    direct = mplan.compute(scores[0])
    gap = max(abs(direct[k] - results[0][k]) for k in ("auc", "mrr", "ndcg5", "ndcg10"))
    log(f"  check 4 ({kind}): metrics vs DeviceMetricsPlan.compute(score): max difference {gap:.3g} (tol 1e-6)")
    if not (gap <= 1e-6 and direct["num_samples"] == results[0]["num_samples"] == FLAT_ROWS):
        raise AssertionError(f"check 4: {direct} vs {results[0]}")

    if dtype == torch.float32:
        rows = boundary_rows(hist_lens, chunk)
        sub, slots = take_rows(rows, hist_rev, hist_lens, cand_rev, imp_lens)
        ends = np.cumsum(hist_lens)
        cuts = np.arange(chunk, int(ends[-1]), chunk)
        straddle = sum(bool(((ends[r] - hist_lens[r] < cuts) & (cuts < ends[r])).any()) for r in rows)
        which = f"{len(rows)} rows about the {len(cuts)} chunk boundaries ({straddle} straddle one)"
        card = scores[0][slots]
        cpu_tower = build_tower(cfg)
        cpu_tower.load_state_dict(state)
        cpu = FlatEvalPlan(*sub, chunk_tokens=1024, cand_chunk=1024, device="cpu").score(cpu_tower, emb.cpu())
        diff = np.abs(cpu - card).max()
        log(f"  check 2: {which}: scores vs the same FlatEvalPlan on the CPU: max difference {diff:.3g} (tol 1e-4)")
        if not (straddle and diff <= 1e-4):
            raise AssertionError(f"check 2: card and CPU differ by {diff}; {straddle} rows straddle a chunk")
        diff = np.abs(padded_scores(tower, emb, *sub) - card).max()
        log(f"  check 5: {which}: flat scores vs the padded, masked tower call: max difference {diff:.3g} (tol 1e-5)")
        if not diff <= 1e-5:
            raise AssertionError(f"check 5: flat and padded paths differ by {diff}")
    return dict(
        scores=scores[0], launches=launches, shapes=shapes, chunk=chunk, peak=peak,
        score_ips=ips[0], metrics_ips=ips[1], busy=prof, metrics=results[0],
    )


def flat_eval_phase(gen) -> dict:
    """The port's flat eval at full width over bench.py's MIND-small-scale
    workload, in float32 and in bfloat16."""
    work = build_workload(np.random.default_rng(SEED))
    hist_lens, imp_lens, _, cand_rev, _, labels = work
    log(
        f"  workload: {FLAT_ROWS:,} rows, {int(hist_lens.sum()):,} history tokens, "
        f"{len(cand_rev):,} candidate slots, {NUM_NEWS:,} news (bench.py's build_workload, seed {SEED})"
    )
    cfg = TowerConfig(kind="latent")
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), cfg))
    # A row-normalized table made on the card, as bench.py makes it.
    emb = torch.randn((NUM_NEWS, cfg.reduced_dim), device="cuda", generator=gen)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True)
    t0 = time.perf_counter()
    mplan = DeviceMetricsPlan(imp_lens, labels, hist_slots=np.arange(len(cand_rev), dtype=np.int64))
    log(f"  DeviceMetricsPlan built in {time.perf_counter() - t0:.2f}s ({len(mplan.grids)} length buckets)")
    runs = {dtype: flat_eval_run(dtype, state, emb, mplan, work) for dtype in (torch.float32, torch.bfloat16)}
    f32, bf16 = runs[torch.float32]["scores"], runs[torch.bfloat16]["scores"]
    rel = float(np.linalg.norm(bf16 - f32) / np.linalg.norm(f32))
    log(f"  check 6: bfloat16 scores vs float32, norm-relative difference {rel:.3g} (tol 3e-2)")
    if not rel <= 3e-2:
        raise AssertionError(f"check 6: bfloat16 and float32 scores differ by {rel}")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    log(card)

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f}s for {sorted(logs)} (nvcc -Xptxas -v):")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("phase 3 kernels vs plain versions on the card, at serving shapes:")
    kernel_phase(gen)

    log("phase 4 serve: full-width latent tower behind build_ranker (TF32 off)")
    work_dir = ROOT / "build" / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    serve = serve_phase("cuda", work_dir, NUM_NEWS, TowerConfig(kind="latent"))
    log(
        f"  rank_batch of {N_REQUESTS} requests: requests/s {['%.1f' % r for r in serve['rps']]} "
        f"on {card}"
    )
    log(f"  4 requests vs the CPU ranker: max |score difference| {serve['cpu_diff']:.3g} (tol 1e-4)")
    if not serve["cpu_diff"] <= 1e-4:
        raise AssertionError(f"GPU and CPU rankers disagree by {serve['cpu_diff']}")

    log("phase 5 kernels vs plain versions at every shape the main path launched them at:")
    served = {
        name: collections.Counter({(s, torch.float32): n for s, n in counts.items()})
        for name, counts in serve["shapes"].items()
    }
    records = {"serve": (main_path_phase(served, gen), serve["launches"])}

    log("phase 6 flat eval: FlatEvalPlan + DeviceMetricsPlan at full width, MIND-small scale (TF32 off)")
    runs = flat_eval_phase(gen)
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the flat eval launched them at:")
    flat = {name: sum((r["shapes"][name] for r in runs.values()), collections.Counter()) for name in KERNELS}
    launches = {name: sum(r["launches"][name] for r in runs.values()) for name in KERNELS}
    records["flat_eval"] = (main_path_phase(flat, gen, path="flat eval"), launches)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": meta["source"],
            "replaces": meta["replaces"],
            "path": path,
            "shape": record[name]["label"],
            "launches": counts[name],
            "max_abs_err": record[name]["err"],
            "ms": record[name]["ms"],
            "plain_ms": record[name]["plain_ms"],
            "bound_ms": record[name]["bound_ms"],
            "bound_by": record[name]["bound_by"],
            "library_ms": record[name]["library_ms"],
            "device_ms": record[name]["device_ms"],
            "plain_device_ms": record[name]["plain_device_ms"],
            "library_device_ms": record[name]["library_device_ms"],
        }
        for path, (record, counts) in records.items()
        for name, meta in KERNELS.items()
    ]
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
