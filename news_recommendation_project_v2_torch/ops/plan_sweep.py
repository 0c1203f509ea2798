"""Device time of the attention kernel under every block shape and slice
count, beside the plan that ``plan_attention`` picks, on one NVIDIA GPU.

    python -m news_recommendation_project_v2_torch.ops.plan_sweep [encoder]

With ``encoder`` it sweeps NV-Embed's pooling head (N = 512, dh = 4,096) at
the batches of news an encode gives it, instead of the user tower's shapes.

For each shape (B, H, L, N, dh) and type (float32, bfloat16, float16) it
prints the library call's time (``scaled_dot_product_attention``, a
yardstick), the planner's plan and its
time, and the fastest plans with their largest difference from the plain
version. Times are device times: ten launches captured in one CUDA graph and
replayed (two at the flat eval's [1, 8, 131072, 512], where only one slice
is tried). This is how the planner's rules were measured (PERF.md, Findings).
"""

from __future__ import annotations

import sys

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
from .timing import graph_ms

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


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
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
