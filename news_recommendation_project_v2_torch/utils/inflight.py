"""Bounded in-flight dispatch window for pipelined device loops.

CUDA work is asynchronous: PyTorch returns once a kernel is queued, and the
host blocks only when it copies a result back (``.cpu()``). Queueing the next
call before fetching the previous one overlaps the host's work with the
device's. The window is bounded because each pending item pins its input and
output buffers.
"""

from __future__ import annotations

from typing import Any, Callable


class InflightWindow:
    """FIFO of at most ``depth`` pending items. ``push`` enqueues and, once
    the window is full, consumes the OLDEST item (fetch order == dispatch
    order, so downstream concatenation stays positional); ``flush`` consumes
    everything left. ``consume`` is where the blocking ``.cpu()`` fetch
    belongs."""

    def __init__(self, depth: int, consume: Callable[[Any], None]):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._consume = consume
        self._pending: list[Any] = []

    def push(self, item: Any) -> None:
        self._pending.append(item)
        self._drain(self.depth)

    def flush(self) -> None:
        self._drain(0)

    def _drain(self, limit: int) -> None:
        while len(self._pending) > limit:
            self._consume(self._pending.pop(0))
