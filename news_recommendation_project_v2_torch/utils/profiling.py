"""Tracing and timing hooks: a ``torch.profiler`` trace of a block, and a
wall-clock timer that waits for the device's queued work."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Path | str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU and, where there is one, the CUDA device) and
    write a Chrome trace to ``log_dir/trace.json``; yields the profiler, so
    ``key_averages()`` can be read after the block."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink: Optional[list] = None) -> Iterator[None]:
    """Wall-clock a block, the device's queued work included: where CUDA is
    in use the clock is read after ``torch.cuda.synchronize()``, at the
    start and at the end. Appends ``(label, seconds)`` to ``sink`` or
    prints it."""
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            print(f"[timed] {label}: {dt:.3f}s")
