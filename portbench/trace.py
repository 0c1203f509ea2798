"""The device trace of a traced window, from ``torch.profiler``: the time
some operation ran on the device (the union of kernels, copies and sets),
the device time and launches of kernels by name, the top operations, and
the idle gaps by what the host was doing (the innermost host operation
open at a gap's middle, or else the last one to end before it; the
``GAPS_NAMED`` longest gaps, summed by it)."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

WINDOW = "portbench.window"
GAPS_NAMED = 500


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _annotation(e) -> bool:
    """A host span mirrored on the device's timeline, not device work."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict  # name -> summed device seconds
    idle_gaps: list  # [[host op, seconds]] summed by host op, longest first

    def seconds(self, part: str) -> float:
        """Device seconds of every kernel whose name holds ``part``."""
        return sum(s for k, s in self.kernel_s.items() if part in k)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": self.idle_gaps[:10]}


@contextlib.contextmanager
def traced(out: list):
    """Profile the block (host and device) and append its ``Trace``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(summarize(prof.profiler.kineto_results.events(), wall))


def summarize(events, wall: float) -> Trace:
    host, device = [], []
    win = None
    for e in events:
        dt = str(e.device_type())
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if "CUDA" in dt:
            if not _annotation(e):
                device.append((start, start + dur, e.name()))
        else:
            if e.name() == WINDOW:
                win = (start, start + dur)
            host.append((start, start + dur, e.name()))
    if win is None:
        win = (min((s for s, _, _ in host), default=0), max((t for _, t, _ in host), default=0))
    w0, w1 = win
    kernel_s = defaultdict(float)
    spans = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        kernel_s[name] += (t - s) / 1e9
        spans.append((s, t))
    spans.sort()
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    gaps = []
    edges = [w0] + [x for m in merged for x in m] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    idle = defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    if gaps and host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        names = [h[2] for h in host]
        for a, b in gaps:
            mid = (a + b) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            cover = [i for i in cover if names[i] != WINDOW]
            if cover:
                name = names[min(cover, key=lambda i: he[i] - hs[i])]
            else:
                done = np.flatnonzero(he <= mid)
                done = [i for i in done if names[i] != WINDOW]
                name = "after " + names[max(done, key=lambda i: he[i])] if done else "(no host op)"
            idle[name] += (b - a) / 1e9
    gaps_by = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])
    window_s = (w1 - w0) / 1e9 if w1 > w0 else wall
    return Trace(window_s, busy / 1e9, dict(kernel_s), gaps_by)
