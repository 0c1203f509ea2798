"""A cross-process file lock for the builds that processes started together
(test workers, the ranks of a mesh) reach at once."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def file_lock(path: Path) -> Iterator[None]:
    """Hold an exclusive ``flock`` on ``path`` (created if missing) for the
    block. The kernel drops it when the holder exits, so a killed build
    leaves no stale lock."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
