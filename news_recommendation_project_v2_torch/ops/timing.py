"""Measures of a call on the card, for the plan sweep and the card tests: a
timer, and a count of the host's waits.

``graph_ms`` captures calls in one CUDA graph and replays it, so that the
host's launch costs are left out: the device time, with the inputs of one
call warm in L2 for the next.
"""

from __future__ import annotations

import warnings

import torch


def graph_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Mean device time of ``fn``: ``reps`` calls captured in one CUDA graph
    and replayed ``rounds`` times. ``fn`` must launch on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    # The graph allocates from a pool of its own: hand the warm-up's cached
    # blocks back first, so a call of tens of GB still has room there.
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def count_syncs(fn) -> int:
    """How many times ``fn`` made the host wait for the card (PyTorch's sync
    debug mode warns at each synchronizing call)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
