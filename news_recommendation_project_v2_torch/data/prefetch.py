"""Background-thread batch prefetching: host-side batch construction
(sampling, dedup, token packing) overlaps the device's steps.

A single daemon thread and a bounded queue are enough because the producers
are vectorized numpy; everything stays in one process (no pickling, no fork
hazards with CUDA)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield items of ``iterable``, produced ahead of time on a daemon thread.

    ``depth`` bounds the queue so producer memory stays bounded. Exceptions in
    the producer re-raise at the consuming site. Abandoning the iterator
    (break / exception / GC) stops the producer promptly instead of leaving it
    blocked forever on a full queue.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - propagated to consumer
            put(e)
            return
        put(_END)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
