"""Device times of the port's kernels under each plan or route, beside the
one its planner picks, on one NVIDIA GPU.

    python -m news_recommendation_project_v2_torch.ops.plan_sweep [encoder|geglu|moe|kda]

Without an argument it sweeps the attention kernel's block shapes and slice
counts at the user tower's shapes (N = 64, dh = 512); with ``encoder`` at
NV-Embed's pooling head (N = 512, dh = 4,096) and the batches of news an
encode gives it. For each shape (B, H, L, N, dh) and type (float32,
bfloat16, float16) it prints the library call's time
(``scaled_dot_product_attention``, a yardstick), the planner's plan and its
time, and the fastest plans with their largest difference from the plain
version. Times are device times: ten launches captured in one CUDA graph and
replayed (two at the flat eval's [1, 8, 131072, 512], where only one slice
is tried).

With ``geglu`` it times the float32 GEGLU on both of its routes (warpgroup
MMA and mma.sync) at C rows about ``WGMMA_MIN_ROWS`` and where the main path
calls it: one request (C = 37), the flat train step (65,536), the flat eval's
chunk (262,144), NV-Embed's tower at D = 4,096. Each line gives the route
``plan_geglu`` picks, each route's device time and largest difference from
the plain version, the plain version's time and the library call's
(``F.linear``, GELU, ``F.linear``). This is how the planners' rules were
measured (PERF.md, Findings).

With ``moe`` it times the routed experts' two grouped kernels
(``ops/moe.py``) at Moonlight's widths (64 experts, D = 2,048, I = 1,408,
top-6) over the token counts of an encode's batches, routed by random
scores, beside the per-expert cuBLAS loop (``F.linear`` on each expert's
rows, the rows' counts read on the host first) and the bound of the work at
the bf16 peak; each line also gives the kernels' largest difference from
the plain version.

With ``kda`` it times the KDA recurrence's chunked kernel (``ops/kda.py``)
at Kimi-Linear's widths (32 heads of 128) over the batches of an article
encode's length buckets (rows x width, every row full, strong decays),
beside its plain chunked version and the bound of its chunk-64 work at the
TF32 peak or the bandwidth; each line also gives the kernel's largest
difference from the plain version.
"""

from __future__ import annotations

import importlib
import sys
from unittest import mock

import torch
import torch.nn.functional as F

from .latent_attention import (
    ROWS,
    SLICE_COLS,
    SMEM_LIMIT,
    _launch,
    attention_smem,
    plan_attention,
    reference_attention,
)
from .kda import kda, reference_kda
from .moe import reference_routed_experts, routed_experts
from .timing import graph_ms

# The module, not the package's ``geglu`` (the wrapper function of that name).
geglu_ops = importlib.import_module(f"{__package__}.geglu")

# (B, H, L) at N=64, dh=512: a single request's history buckets, then B·L
# from 512 to 4,800 folded rows, the served buckets 256 and 600 at moderate B
# among them.
SHAPES = [
    (1, 8, 16), (1, 8, 64), (1, 8, 128), (1, 8, 256), (8, 8, 64), (2, 8, 256), (4, 8, 256),
    (2, 8, 600), (4, 8, 300), (4, 8, 600), (8, 8, 600),
]

# float16 takes bfloat16's plans; both are swept.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# (B, H, L) at NV-Embed's pooling head, N=512, dh=4,096: one news of 16
# tokens, then batches of news of 32 and 64 tokens.
ENCODER_SHAPES = [(1, 8, 16), (8, 8, 32), (32, 8, 32), (128, 8, 32), (64, 8, 64)]


def sweep(shape, dtype, gen) -> str:
    b, h, l, n, dh = shape
    q, k, v = (
        torch.randn(*s, device="cuda", generator=gen).to(dtype)
        for s in ((b, h, l, dh), (h, n, dh), (h, n, dh))
    )
    out = torch.empty_like(q)
    want = reference_attention(q, k, v).float()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan_attention(b, h, l, n, dh, dtype, sms)
    steps = -(-dh // SLICE_COLS)
    long = b * l > 10_000  # the flat eval: one slice, fewer replays
    reps = (2, 2) if long else (10, 5)
    times = {}
    for rows in ROWS:
        if attention_smem(rows, n, dtype) > SMEM_LIMIT:
            continue
        for slices in sorted({-(-dh // (-(-steps // s) * SLICE_COLS)) for s in ((1,) if long else (1, 2, 4, 8, 16, 32))}):
            width = -(-steps // slices) * SLICE_COLS

            def call(rows=rows, slices=slices, width=width):
                _launch(q, k, v, out, rows, slices, width)

            call()
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            times[(rows, slices)] = (graph_ms(call, *reps), err)
    ke, ve = k.expand(b, h, n, dh), v.expand(b, h, n, dh)
    library = graph_ms(lambda: F.scaled_dot_product_attention(q, ke, ve), *reps)
    best = sorted(times.items(), key=lambda kv: kv[1][0])[:4]
    return (
        f"{str(dtype)[6:]} B={b} H={h} L={l} N={n} dh={dh}: library {library:.4f} ms; "
        f"plan rows={plan.rows} S={plan.slices} {times[(plan.rows, plan.slices)][0]:.4f} ms "
        f"({times[(plan.rows, plan.slices)][0] / library:.2f}x the library); fastest "
        + ", ".join(f"rows={r} S={s} {t:.4f} ms (err {e:.2g})" for (r, s), (t, e) in best)
    )


# (C, D, F) of the float32 GEGLU: about the warpgroup route's first rows, then
# the main path's calls at D = 1,024 and at NV-Embed's tower (D = 4,096).
GEGLU_SHAPES = [
    (37, 1024, 4096), (128, 1024, 4096), (192, 1024, 4096), (256, 1024, 4096), (4096, 1024, 4096),
    (65536, 1024, 4096), (262144, 1024, 4096), (128, 4096, 16384), (256, 4096, 16384), (8192, 4096, 16384),
]


def geglu_library(x, w_in, b_in, w_out, b_out):
    h, g = F.linear(x, w_in, b_in).chunk(2, dim=-1)
    return F.linear(h * F.gelu(g, approximate="tanh"), w_out, b_out)


def sweep_geglu(shape, gen) -> str:
    c, d, f = shape
    args = tuple(
        torch.randn(*s, device="cuda", generator=gen) * scale
        for s, scale in (((c, d), 1.0), ((2 * f, d), d**-0.5), ((2 * f,), 0.02), ((d, f), f**-0.5), ((d,), 0.02))
    )
    props = torch.cuda.get_device_properties(0)
    picked = geglu_ops.plan_geglu(c, d, f, torch.float32, props.multi_processor_count, props.L2_cache_size)
    plans = {
        "wgmma": geglu_ops._plan_wgmma(c, d, f, props.multi_processor_count),
        "mma_sync": geglu_ops.plan_geglu(
            c, d, f, torch.float32, props.multi_processor_count, props.L2_cache_size, aligned=False
        ),
    }
    ops = 6.0 * c * d * f
    reps = (10, 5) if ops < 1e10 else (1, 5) if ops < 1e12 else (1, 2)
    want = geglu_ops.reference_geglu(*args)
    times = {}
    for route, plan in plans.items():
        if plan is None:
            continue
        # The wrapper under the route's plan, past the planner.
        with mock.patch.object(geglu_ops, "plan_geglu", lambda *_, plan=plan: plan):
            before = geglu_ops.geglu.routes[(route, torch.float32)]
            err = (geglu_ops.geglu(*args) - want).abs().max().item()
            assert geglu_ops.geglu.routes[(route, torch.float32)] == before + 1, route
            times[route] = (graph_ms(lambda: geglu_ops.geglu(*args), *reps), err)
    del want
    plain = graph_ms(lambda: geglu_ops.reference_geglu(*args), *reps)
    library = graph_ms(lambda: geglu_library(*args), *reps)
    return (
        f"float32 C={c} D={d} F={f}: plan {picked.route}; "
        + "; ".join(f"{r} {t:.4f} ms (err {e:.2g})" for r, (t, e) in times.items())
        + f"; plain {plain:.4f} ms; library {library:.4f} ms"
    )


# Tokens of an encode batch at Moonlight's widths: the passage bucket's
# (2,048 rows of ~22 real tokens), the query bucket's (~50 real tokens a
# row), and a small batch.
MOE_TOKENS = (4096, 45056, 102400)
MOE_WIDTHS = (64, 6, 2048, 1408)  # experts, top-k, D, I


def sweep_moe(tokens: int, gen) -> str:
    e, k, d, i = MOE_WIDTHS
    dev = "cuda"
    picked = torch.topk(torch.rand(tokens, e, device=dev, generator=gen), k, dim=-1).indices.reshape(-1)
    order = torch.argsort(picked, stable=True)
    offsets = torch.searchsorted(picked[order], torch.arange(e + 1, device=dev)).to(torch.int32)
    m = tokens * k
    xs = torch.randn(m, d, device=dev, generator=gen).to(torch.bfloat16)
    w_gate_up = (torch.randn(e, 2 * i, d, device=dev, generator=gen) * d**-0.5).to(torch.bfloat16)
    w_down = (torch.randn(e, d, i, device=dev, generator=gen) * i**-0.5).to(torch.bfloat16)
    pair_w = torch.rand(m, device=dev, generator=gen)
    bounds = offsets.tolist()

    def library():
        y = torch.empty(m, d, device=dev)
        for x in range(e):
            lo, hi = bounds[x], bounds[x + 1]
            g, u = F.linear(xs[lo:hi], w_gate_up[x]).chunk(2, dim=-1)
            y[lo:hi] = F.linear(F.silu(g) * u, w_down[x]).float() * pair_w[lo:hi, None]
        return y

    want = reference_routed_experts(xs, offsets, w_gate_up, w_down, pair_w)
    err = ((routed_experts(xs, offsets, w_gate_up, w_down, pair_w) - want).abs().max() / want.abs().max()).item()
    kernel = graph_ms(lambda: routed_experts(xs, offsets, w_gate_up, w_down, pair_w), 2, 5)
    loop = graph_ms(library, 2, 5)
    bound = 2.0 * 3 * d * i * m / 9.89e14 * 1e3
    return (
        f"moe tokens={tokens} rows={m} E={e} D={d} I={i}: kernels {kernel:.4f} ms "
        f"({bound / kernel:.1%} of the bf16 peak; err {err:.2g} of the largest); "
        f"cuBLAS loop {loop:.4f} ms ({bound / loop:.1%}); bound {bound:.4f} ms"
    )


# (B, T) of an article encode's batches: its length buckets at the batches
# the memory model and the even split give a unit of 128 articles.
KDA_SHAPES = ((16, 4096), (48, 2048), (96, 1024), (64, 512), (32, 256))
KDA_HEADS, KDA_DIM = 32, 128


def sweep_kda(shape, gen) -> str:
    b, t = shape
    h, d, dev = KDA_HEADS, KDA_DIM, "cuda"
    q = (F.normalize(torch.randn(b, t, h, d, device=dev, generator=gen), dim=-1) * d**-0.5).to(torch.bfloat16)
    k = F.normalize(torch.randn(b, t, h, d, device=dev, generator=gen), dim=-1).to(torch.bfloat16)
    v = torch.randn(b, t, h, d, device=dev, generator=gen).to(torch.bfloat16)
    a = torch.rand(h, device=dev, generator=gen) * 15 + 1
    log_alpha = -a[:, None] * F.softplus(torch.randn(b, t, h, d, device=dev, generator=gen))
    beta = torch.rand(b, t, h, device=dev, generator=gen)
    args = (q, k, v, log_alpha, beta)
    want = reference_kda(*args).float()
    err = ((kda(*args).float() - want).abs().max() / want.abs().max()).item()
    del want
    kernel = graph_ms(lambda: kda(*args), 2, 5)
    plain = graph_ms(lambda: reference_kda(*args), 1, 2)
    per_head = 3 * d * d + 64 * (3 * d + 2 * d)  # multiply-adds a token, chunk-64 form (portbench/kda.py)
    ops, nbytes = 2.0 * h * per_head * b * t, (3 * 2 + 4 + 2) * h * d * b * t + 4 * h * b * t
    bound = max(ops / 4.95e14, nbytes / 3.35e12) * 1e3
    return (
        f"kda B={b} T={t} H={h} d={d}: kernel {kernel:.4f} ms ({bound / kernel:.1%} of its roofline; "
        f"err {err:.2g} of the largest); plain chunked {plain:.4f} ms ({bound / plain:.1%}); bound {bound:.4f} ms"
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        if sys.argv[1:] == ["kda"]:
            for shape in KDA_SHAPES:
                print(sweep_kda(shape, gen), flush=True)
                torch.cuda.empty_cache()
            return 0
        if sys.argv[1:] == ["moe"]:
            for tokens in MOE_TOKENS:
                print(sweep_moe(tokens, gen), flush=True)
                torch.cuda.empty_cache()
            return 0
        if sys.argv[1:] == ["geglu"]:
            for shape in GEGLU_SHAPES:
                print(sweep_geglu(shape, gen), flush=True)
                torch.cuda.empty_cache()
            return 0
        if sys.argv[1:] == ["encoder"]:
            for dtype in DTYPES:
                for b, h, l in ENCODER_SHAPES:
                    print(sweep((b, h, l, 512, 4096), dtype, gen), flush=True)
            return 0
        for dtype in DTYPES:
            for b, h, l in SHAPES:
                print(sweep((b, h, l, 64, 512), dtype, gen), flush=True)
            print(sweep((2, 3, 5, 70, 100), dtype, gen), flush=True)
        print(sweep((1, 8, 131072, 64, 512), torch.float32, gen), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
