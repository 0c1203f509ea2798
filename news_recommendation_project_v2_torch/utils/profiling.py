"""Tracing and timing hooks: a ``torch.profiler`` trace of a block, the
port's own spans and counters, and a wall-clock timer that waits for the
device's queued work.

Spans and counters (``span``, ``count``) record only while a unit of work
(``unit``: a training epoch, an eval) runs on a thread that
``torch.profiler`` records, or inside ``profile_trace``. Otherwise
``span`` hands back a shared no-op context after one flag check and
``count`` returns at once. Recording is per thread: a unit decides it once
as it starts, and hands it to the threads it feeds from (``recording(on)``,
as ``data.prefetch`` does for its producer). On a thread the profiler
records, a span also opens a record function of its name, so it lies in
the same trace as the device's kernels: torch's C++ ``_RecordFunctionFast``
where torch has it, else ``torch.profiler.record_function``, whose Python
calls give up the GIL and can come back milliseconds late while another
thread runs (and cost ~17 us a span against ~2). Every span's start
and end are Unix-epoch nanoseconds, the clock of the profiler's events
(``start_ns()``). Records stay in memory until ``clear()``."""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the enclosing span on its thread
    thread: str


class Recorded(NamedTuple):
    spans: list[Span]
    counters: dict[str, int]


class _ThreadState(threading.local):
    on = False  # spans and counters record on this thread
    mirror = False  # the profiler records this thread: spans open record_function too

    def __init__(self):
        self.stack: list[str] = []


_state = _ThreadState()
_spans: list[Span] = []
_counters: dict[str, int] = {}
_device_counters: dict[str, list[torch.Tensor]] = {}
_lock = threading.Lock()
_OFF = contextlib.nullcontext()
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class _Open:
    __slots__ = ("name", "parent", "start", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _state.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.fn = None
        self.start = time.time_ns()
        if _state.mirror:
            self.fn = _record_function(self.name)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _state.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.parent, threading.current_thread().name))
        return False


def active() -> bool:
    """Whether spans and counters record on this thread."""
    return _state.on


def span(name: str):
    """A context that records ``name``'s start and end where recording is
    on (a shared no-op context where it is off)."""
    if not _state.on:
        return _OFF
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` where recording is on."""
    if not _state.on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def count_device(name: str, n: torch.Tensor) -> None:
    """Add ``n``, a count that lives on the device, to the counter ``name``
    where recording is on: each count is kept on the device, with no wait,
    and they are summed once, by ``recorded``. They are not added as they
    come: the counts of one unit may come from several streams, and a
    running sum on one stream would read another's count before it is
    written."""
    if not _state.on:
        return
    with _lock:
        _device_counters.setdefault(name, []).append(n.detach().to(torch.int64))


@contextlib.contextmanager
def recording(on: Optional[bool] = None) -> Iterator[bool]:
    """Record on this thread while the block runs: where ``on`` is given,
    as it says (a producer thread takes its unit's decision); else where
    ``torch.profiler`` records this thread, or an enclosing block records.
    Yields whether it records."""
    saved = _state.on, _state.mirror
    _state.mirror = torch.autograd._profiler_enabled()
    _state.on = (_state.on or _state.mirror) if on is None else on
    try:
        yield _state.on
    finally:
        _state.on, _state.mirror = saved


def unit(name: str) -> Callable:
    """Decorate a unit of work: each call decides whether it records
    (``recording()``) and runs inside the span ``name``; a call made inside
    a recording span ``name`` on its thread belongs to that unit and opens
    none of its own."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if name in _state.stack:
                return fn(*args, **kwargs)
            with recording(), span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def recorded() -> Recorded:
    """The spans (in the order they ended) and counters recorded so far;
    the device's counters are read here (a wait for the device)."""
    with _lock:
        counters = dict(_counters)
        for name, parts in _device_counters.items():
            if parts[0].is_cuda:
                torch.cuda.synchronize(parts[0].device)  # every stream's counts written
            counters[name] = counters.get(name, 0) + int(torch.stack(parts).sum())
        return Recorded(list(_spans), counters)


def clear() -> None:
    """Drop every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _device_counters.clear()


@contextlib.contextmanager
def profile_trace(log_dir: Path | str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU and, where there is one, the CUDA device) and
    write a Chrome trace to ``log_dir/trace.json``; yields the profiler, so
    ``key_averages()`` can be read after the block. The block records the
    port's spans and counters (the records cleared first), written to
    ``log_dir/spans.json``: they hold the threads the Chrome trace lacks,
    such as the trainers' prefetch producer."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        clear()
        with recording(True):
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    spans, counters = recorded()
    with open(log_dir / "spans.json", "w") as f:
        json.dump({"spans": [s._asdict() for s in spans], "counters": counters}, f)


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
