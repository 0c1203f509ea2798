"""Background-thread batch prefetching: host-side batch construction
(sampling, dedup, token packing) overlaps the device's steps.

A single daemon thread and a bounded queue are enough because the producers
are vectorized numpy; everything stays in one process (no pickling, no fork
hazards with CUDA)."""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator, Optional, TypeVar

from ..utils import profiling

T = TypeVar("T")

_END = object()
_NOOP = contextlib.nullcontext()


def prefetch(iterable: Iterable[T], depth: int = 2, spans: Optional[tuple[str, str]] = None) -> Iterator[T]:
    """Yield items of ``iterable``, produced ahead of time on a daemon thread.

    ``depth`` bounds the queue so producer memory stays bounded. Exceptions in
    the producer re-raise at the consuming site. Abandoning the iterator
    (break / exception / GC) stops the producer promptly instead of leaving it
    blocked forever on a full queue.

    ``spans``, ``(wait, build)``, names the ``utils.profiling`` spans of the
    consumer blocked on the queue for its next item and of the producer
    building one; the producer records where the consumer's thread records
    as iteration starts.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    wait, build = spans or (None, None)
    record = spans is not None and profiling.active()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        with profiling.recording(record):
            try:
                items = iter(iterable)
                while True:
                    with profiling.span(build) if build else _NOOP:
                        item = next(items, _END)
                    if item is _END:
                        break
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - propagated to consumer
                put(e)
                return
            put(_END)

    thread = threading.Thread(target=worker, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            with profiling.span(wait) if wait else _NOOP:
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
