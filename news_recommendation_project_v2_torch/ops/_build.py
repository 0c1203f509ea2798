"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, ``build/kernels/lib<name>-<hash>.so`` at the root of the
checkout. The hash covers the sources and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. Building happens at first use
(``load``) or up front for all sources at once (``build``, one ``nvcc`` per
source, all started together). A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    path = home / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile the named sources (default: all) that have no current library,
    in parallel. Returns nvcc's output per source compiled here (register and
    shared-memory use from ``-Xptxas -v``); sources already built are absent."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            logs[name] = log
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.nr_error_string.argtypes = [ctypes.c_int]
            lib.nr_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A launcher of library ``name``, declared to take ``argtypes`` and to
    return the CUDA error code as an int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error code."""
    if code != 0:
        msg = load(name).nr_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {code} ({msg})")


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers' plain-version
    case. Any other placement must pass ``validate`` and launch the kernel."""
    return all(t.is_cpu for t in tensors)


def validate(name: str, tensors) -> None:
    """What the kernels take: tensors on one CUDA device, all float32 or all
    bfloat16, contiguous, and no autograd recording. The wrappers reach a
    kernel only through their ``torch.autograd.Function``, whose forward runs
    with grad mode off; the refusal guards direct calls of a kernel, which
    has no backward of its own."""
    import torch

    index, dtype = tensors[0].get_device(), tensors[0].dtype
    if not all(t.is_cuda and t.get_device() == index for t in tensors):
        raise ValueError(
            f"{name}: inputs must all lie on one CUDA device (or all on the "
            f"CPU), got {[str(t.device) for t in tensors]}"
        )
    if dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dtype for t in tensors
    ):
        raise TypeError(
            f"{name}: inputs must all be float32 or all bfloat16, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only; under autograd call "
            f"ops.{name}.{name}, whose autograd Function gives it a backward"
        )
