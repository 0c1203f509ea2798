"""The mesh: the world's ranks as a ``(data, model)`` grid.

A rank is the port's device. Where the JAX package lays a mesh over the
devices of one process, the port runs one process per rank, joined by
``torch.distributed``: rank ``r`` sits at ``(r // model, r % model)`` and
runs on ``cuda:(LOCAL_RANK % device_count)``. The ``data`` axis shards the
batches (data parallelism), the ``model`` axis the news table's rows. Each
rank joins three process groups: its row of the grid (the ranks that share
its data index and so its batch: the table's row shards), its column (the
ranks that share its model index: the gradient reduction) and the whole
world (the token store's shards, mesh serving's broadcasts), each with the
mesh's timeout.

Backends follow the device the caller trains on (``default_backend``):
NCCL for CUDA, gloo for the CPU. gloo carries CUDA tensors too, but only
when the caller names it, which is how two ranks share one card (NCCL
refuses two ranks on one GPU); a group whose backend cannot carry the
caller's tensors is refused, never swapped. Every group has a timeout, so a
dead peer fails the run instead of hanging it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import MeshConfig

DEFAULT_TIMEOUT = timedelta(minutes=10)


class Mesh:
    """One rank's view of the mesh: its coordinates, the grid's shape and
    its two process groups (None where the world is one process).

    ``sum(tensor, axis)`` adds ``tensor`` in place over ``"data"``,
    ``"model"`` or (``axis=None``) every rank; a group of one adds nothing."""

    def __init__(
        self, config: MeshConfig, data: int, model: int, rank: int, data_group=None, model_group=None, world_group=None
    ):
        self.axis_names = (config.data_axis, config.model_axis)
        self.shape = {config.data_axis: data, config.model_axis: model}
        self.data_size, self.model_size = data, model
        self.size = data * model
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self._groups = {"data": data_group, "model": model_group, None: world_group}

    def axis_size(self, axis: Optional[str]) -> int:
        return {None: self.size, "data": self.data_size, "model": self.model_size}[axis]

    def sum(self, tensor: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        if self.axis_size(axis) > 1:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self._groups[axis])
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``tensor`` from rank ``src`` to every rank, in place."""
        if self.size > 1:
            dist.broadcast(tensor, src=src, group=self._groups[None])
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """Every rank's ``tensor`` along ``axis``, in axis order (all the same
        shape)."""
        if self.axis_size(axis) == 1:
            return [tensor]
        parts = [torch.empty_like(tensor) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, tensor.contiguous(), group=self._groups[axis])
        return parts

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def default_backend(device=None) -> str:
    """The backend for ``device``'s tensors: gloo for the CPU, NCCL for CUDA
    (``device=None`` means CUDA, as everywhere in the port)."""
    return "gloo" if torch.device("cuda" if device is None else device).type == "cpu" else "nccl"


def _set_rank_device(local_rank: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def multihost_init(backend: Optional[str] = None, device=None, timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``) over ``backend``, by default ``default_backend(device)``,
    on ``cuda:(LOCAL_RANK % device_count)``; a no-op in one process without
    that environment, or when already joined."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    _set_rank_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or default_backend(device), timeout=timeout)


def build_mesh(
    config: MeshConfig = MeshConfig(),
    backend: Optional[str] = None,
    device=None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """The mesh over the world's ranks (joining torchrun's group first where
    its environment is set, over ``backend`` or ``default_backend(device)``;
    one process without it is a world of one). A group that is already
    joined keeps the backend it was started with: it must be ``backend``
    where one is named, and must carry ``device``'s tensors (NCCL does not
    carry the CPU's). ``data_size=-1`` infers the data axis as
    ``world / model_size``; the sizes must divide the world. Every rank
    calls this, in the same order as its other collective calls."""
    multihost_init(backend, device, timeout)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dist.is_initialized():
        running = dist.get_backend()
        if backend is not None and running != backend:
            raise ValueError(f"the process group runs {running}, not the {backend} asked for")
        if default_backend(device) == "gloo" and "gloo" not in running:
            raise ValueError(f"the process group runs {running}, which cannot carry the CPU's tensors")
    model = max(1, config.model_size)
    data = config.data_size if config.data_size > 0 else max(world // model, 1)
    if data * model != world:
        raise ValueError(
            f"a {data}x{model} mesh needs {data * model} ranks and the world has {world}: "
            f"start one process per rank (torchrun --nproc-per-node {data * model})"
        )
    data_group = model_group = world_group = None
    if world > 1:
        # Every rank creates every group, in one order (new_group's rule).
        world_group = dist.new_group(list(range(world)), timeout=timeout)
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)], timeout=timeout)
            if rank // model == d:
                model_group = group
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)], timeout=timeout)
            if rank % model == m:
                data_group = group
    return Mesh(config, data, model, rank, data_group, model_group, world_group)


def _launched_rank(
    rank: int, fn: Callable, args: Sequence, world_size: int, backend: str, tmp: str, timeout: float
) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    _set_rank_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size, timeout=timedelta(seconds=timeout)
    )
    try:
        result = fn(*args)
        out = Path(tmp, f"rank{rank}.pkl")
        out.with_suffix(".tmp").write_bytes(pickle.dumps(result))
        os.replace(out.with_suffix(".tmp"), out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (), *, backend: str, timeout: float = 600.0) -> list[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks joined over
    ``backend`` (``"gloo"`` or ``"nccl"``, named by the caller: the ranks'
    device is ``fn``'s business) and return each rank's result, in rank
    order.

    The ranks meet through a ``FileStore`` in a temporary directory (no TCP
    port to race for), start by ``spawn`` (``fn`` must be importable by its
    module path) and must all finish within ``timeout`` seconds, which also
    bounds each collective: past it every rank is killed and this raises
    ``TimeoutError``. A rank that raises kills the others, and this raises
    with its traceback."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _launched_rank,
            args=(fn, tuple(args), world_size, backend, tmp, timeout),
            nprocs=world_size,
            start_method="spawn",
            join=False,
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        # Results this program's own ranks wrote.
        return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes()) for r in range(world_size)]
