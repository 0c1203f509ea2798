"""The native behaviors compiler (``behaviors_compiler.cpp``), a CPython
extension built with ``g++`` at first use into ``build/native/`` at the root
of the checkout, and loaded from there.

The library's name carries a hash of the source, the flags and the Python
headers, so an edited source is rebuilt and a stale library never loads. The
build runs under a cross-process file lock and writes a temporary file that
is renamed into place, so processes that start together (test workers, the
ranks of a mesh) build it once and never load half a file. Where it cannot
be built (no ``g++``, no ``Python.h``), ``load`` warns once and returns
None, and ``data.compiler.compile_behaviors`` takes its numpy path.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
import warnings
from pathlib import Path
from typing import Optional

from ..utils.locking import file_lock

SRC = Path(__file__).resolve().parent / "behaviors_compiler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
MODULE = "_nrtorch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++20")

_lock = threading.Lock()
_state: dict = {}  # "module": the loaded extension, or None once a build failed


def library_path() -> Path:
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(" ".join((*FLAGS, include)).encode())
    h.update(SRC.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{MODULE}-{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension unless a current one exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output when ``g++`` fails,
    ``OSError`` when it cannot run."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with file_lock(BUILD_DIR / ".lock"):
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        include = sysconfig.get_paths()["include"]
        cmd = ["g++", *FLAGS, f"-I{include}", str(SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> Optional[object]:
    """The extension module, built first if needed; None (after one
    warning) where it cannot be built."""
    with _lock:
        if "module" not in _state:
            try:
                path = build()
            except (RuntimeError, OSError, subprocess.SubprocessError) as err:
                warnings.warn(f"native behaviors compiler unavailable, using numpy: {err}", RuntimeWarning)
                _state["module"] = None
            else:
                loader = importlib.machinery.ExtensionFileLoader(MODULE, str(path))
                spec = importlib.util.spec_from_file_location(MODULE, str(path), loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _state["module"] = module
        return _state["module"]
