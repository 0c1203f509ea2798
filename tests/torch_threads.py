"""Torch's intra-op threads for the port's CPU tests (``test_torch_*.py``).

Under pytest-xdist every worker's torch would start a pool of one thread a
core, so six workers keep six pools on the same cores; at the tests' small
shapes each pool then spends more time waiting on the others than
computing. Each ``test_torch_*.py`` file imports the ``torch_threads``
fixture below, which is autouse and module-scoped: for the module's tests,
and for its module-scoped fixtures, torch gets the worker's share of the
cores, ``max(1, os.cpu_count() // workers)`` with ``workers`` from
``PYTEST_XDIST_WORKER_COUNT`` (1 without xdist), and the old count is put
back afterwards. The JAX package's own test files keep their threads.

    from torch_threads import torch_threads  # noqa: F401  (autouse)
"""

from __future__ import annotations

import os

import pytest
import torch


def worker_threads() -> int:
    """This worker's share of the cores."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(threads)
