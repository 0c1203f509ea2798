"""The flat train step as CUDA graphs, one per input signature.

A signature is the shape and type of every tensor of a batch; for the flat
step that is the token stream's length T, which ``_epoch_batches_flat`` pads
to a power of two, everything else being padded to ``batch_size``. The
step (forward through both kernels, backward, ``ClippedAdamW`` and the
gradients cleared) is captured whole once per signature and replayed for
every later batch of it: a step then costs the host seven copies from pinned
memory into the graph's static inputs and one graph launch, not the ~300
launches of the eager step.

A signature's first step runs eagerly on the side stream the capture uses:
the optimizer's state, the kernels' libraries and plans, and cuBLAS's
workspace come into being there, outside any graph. Its second step is
captured and replayed, and every later one replayed. Every graph allocates
from one shared memory pool; the graphs never run at once, and each writes
its temporaries before it reads them. Past ``cap`` signatures a batch runs
eagerly.

A graph holds the addresses of what the step reads (its static inputs, the
parameters, the optimizer's state, the tables) and the optimizer's
hyperparameters as constants. So ``clear`` drops every graph where one of
those is replaced (``TowerTrainer.set_tables``,
``restore_training_state``), and each call compares the hyperparameters with
the captured ones and clears on any difference (a ``PlateauScheduler`` cut
of the learning rate). A cleared signature starts again from its warm-up.

Where ``utils.profiling`` records, the counters ``train.graph_captures`` and
``train.graph_replays`` count captures and steps served by a replay (the
captured step's own replay included); the steps that ran eagerly are
``train.steps`` less the replays.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from ..utils import profiling

# Signatures a trainer keeps graphs for: the flat step's T takes a few powers
# of two, so a ninth signature means shapes that do not repeat.
MAX_GRAPHS = 8


def signature(batch: tuple) -> tuple:
    """The shape and type of every tensor of ``batch``."""
    return tuple((tuple(t.shape), t.dtype) for t in batch)


def hyperparameters(optimizer: torch.optim.Optimizer) -> tuple:
    """What a captured optimizer step holds as constants: every param
    group's settings but its parameters, and the clip's ``max_norm``."""
    groups = tuple(tuple(sorted((k, v) for k, v in g.items() if k != "params")) for g in optimizer.param_groups)
    return groups, getattr(optimizer, "max_norm", None)


class _Graph:
    """One captured step: its static inputs, the graph, its static loss."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: tuple, loss: torch.Tensor):
        self.graph, self.inputs, self.loss = graph, inputs, loss

    def __call__(self, batch: tuple) -> torch.Tensor:
        """Copy ``batch`` into the static inputs, replay, and return a fresh
        tensor of the loss: the next replay overwrites the static one while
        the trainer may still hold this step's."""
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return self.loss.clone()


class StepGraphs:
    """``step(batch) -> loss`` served by CUDA graphs per ``signature``, as
    the module docstring sets out. A call takes the step and the batch on
    the host, pinned: a replay copies it straight into the graph's static
    inputs, and an eager step (a warm-up, a capture, past the cap) first
    copies it to ``device``. ``step`` must run its whole optimizer step on the
    current stream without a host sync, and ``optimizer`` must be built
    ``capturable``."""

    def __init__(self, optimizer: torch.optim.Optimizer, device: torch.device):
        self.optimizer = optimizer
        self.device = device
        self.cap = MAX_GRAPHS
        self.graphs: dict = {}
        self.warmed: set = set()
        self.hyper: Optional[tuple] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def clear(self) -> None:
        """Drop every graph and warm-up. A replay still in flight is safe:
        its pool serves no allocation outside its graphs' captures, the next
        capture takes a new pool, and the static inputs were last read on the
        current stream, which orders any later use of their memory."""
        self.graphs.clear()
        self.warmed.clear()
        self._pool = None

    def __call__(self, step: Callable[[tuple], torch.Tensor], batch: tuple) -> torch.Tensor:
        hyper = hyperparameters(self.optimizer)
        if hyper != self.hyper:
            self.clear()
            self.hyper = hyper
        key = signature(batch)
        graph = self.graphs.get(key)
        if graph is None:
            batch = tuple(t.to(self.device, non_blocking=True) for t in batch)
            if len(self.graphs) >= self.cap:
                return step(batch)
            if key not in self.warmed:
                self.warmed.add(key)
                return self._warm_up(step, batch)
            graph = self.graphs[key] = self._capture(step, batch)
            profiling.count("train.graph_captures")
        profiling.count("train.graph_replays")
        return graph(batch)

    def _side(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _warm_up(self, step: Callable[[tuple], torch.Tensor], batch: tuple) -> torch.Tensor:
        """The step eagerly on the capture's stream, ordered after the
        current stream's work and before its later work."""
        side, current = self._side(), torch.cuda.current_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = step(batch)
        current.wait_stream(side)
        return loss

    def _capture(self, step: Callable[[tuple], torch.Tensor], batch: tuple) -> _Graph:
        """The step captured over static copies of ``batch``. The capture
        errs only on this thread's unsafe calls: the trainer's producer
        thread pins the next batches meanwhile. Freeing a graph is such a
        call, so garbage that holds one (another trainer's, in a reference
        cycle) is collected first and the collector held off until the
        capture ends."""
        inputs = tuple(t.clone() for t in batch)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side(), capture_error_mode="thread_local"):
                loss = step(inputs)
        finally:
            if collecting:
                gc.enable()
        return _Graph(graph, inputs, loss)
