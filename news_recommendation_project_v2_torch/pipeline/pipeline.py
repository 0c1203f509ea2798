"""The step pipeline, with a cache keyed by content.

``PipelineComponent`` has ``transform`` and ``train`` and declares the
context keys it needs; ``Pipeline`` runs named steps over a (context,
val_context) pair and caches each step's output. A step's cache key chains
a fingerprint of the entry contexts' whole content with the configuration
of every component up to that step, so a change to the data or to an
earlier step's settings never reuses a stale artifact.

Contexts hold numpy arrays and host objects, not CUDA tensors: a cached
step pickles them. The fingerprint hashes arrays by their bytes (object
arrays, lists and tuples by their values), dataclasses field by field and
dicts key by key.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Iterable, Optional

import numpy as np


def _digest_value(h: "hashlib._Hash", value: Any) -> None:
    """Fold ``value``'s whole content into ``h``: a change to any element of
    an array, list, dataclass or dict changes the digest."""
    h.update(type(value).__name__.encode())
    if isinstance(value, (str, int, float, bool, bytes, Path)) or value is None:
        h.update(repr(value).encode())
    elif isinstance(value, np.ndarray):
        h.update(str((value.shape, value.dtype)).encode())
        if value.size:
            if value.dtype == object:
                h.update(repr(value.tolist()).encode())
            else:
                h.update(np.ascontiguousarray(value).tobytes())
    elif hasattr(value, "__dataclass_fields__"):
        for f in value.__dataclass_fields__:
            _digest_value(h, getattr(value, f))
    elif isinstance(value, dict):
        h.update(str(len(value)).encode())
        for k in sorted(value, key=repr):
            h.update(repr(k).encode())
            _digest_value(h, value[k])
    elif isinstance(value, (list, tuple)):
        h.update(str(len(value)).encode())
        for v in value:
            _digest_value(h, v)
    else:
        h.update(repr(type(value)).encode())


def fingerprint_context(context: dict[str, Any]) -> str:
    h = hashlib.sha256()
    for key in sorted(context):
        h.update(key.encode())
        _digest_value(h, context[key])
    return h.hexdigest()[:16]


def check_req_keys(required_keys: set[str], context: dict[str, Any]) -> None:
    for key in required_keys:
        assert key in context, f"Required key {key!r} is not present in context"


class PipelineComponent(ABC):
    required_keys: set[str] = set()
    train_required_keys: set[str] = set()
    cacheable: bool = True

    @abstractmethod
    def transform(self, context: dict[str, Any]) -> dict[str, Any]:
        ...

    def train(
        self,
        context: dict[str, Any],
        val_context: Optional[dict[str, Any]] = None,
    ) -> None:
        pass

    def cache_token(self) -> str:
        """The configuration mixed into the step's cache key: scalar,
        tuple and dataclass fields by value, callables by qualified name,
        any other object by its type (its content is taken to follow from
        the hashed configuration, e.g. weights drawn from a seed). A
        component whose behaviour depends on other content overrides this."""
        parts = []
        for key, value in sorted(self.__dict__.items()):
            if isinstance(value, (str, int, float, bool, bytes, Path, tuple)) or (
                value is None or hasattr(value, "__dataclass_fields__")
            ):
                parts.append(f"{key}={value!r}")
            elif callable(value):
                parts.append(f"{key}={getattr(value, '__qualname__', type(value).__name__)}")
            else:
                parts.append(f"{key}=<{type(value).__name__}>")
        return "|".join(parts)


class Pipeline:
    """Named steps run in order over (context, val_context), each step's
    output cached in ``cache_dir`` under its chained key."""

    def __init__(
        self,
        name: str,
        steps: Iterable[tuple[str, PipelineComponent]],
        use_cache: bool = True,
        cache_dir: Path = Path("cache"),
    ):
        self.name = name
        self._steps = list(steps)
        self.use_cache = use_cache
        self.cache_dir = Path(cache_dir)
        # (step name, host seconds, whether the cache answered) per step run
        self.step_log: list[tuple[str, float, bool]] = []
        if use_cache:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _cache_path(self, step_name: str, component: PipelineComponent, chain: str) -> Path:
        token = hashlib.sha256(
            f"{self.name}|{step_name}|{type(component).__name__}|{component.cache_token()}|{chain}".encode()
        ).hexdigest()[:16]
        return self.cache_dir / f"{self.name}_{step_name}_{token}.pkl"

    def _iterate(
        self,
        context: dict[str, Any],
        val_context: Optional[dict[str, Any]],
        training: bool,
    ):
        # The chain: the entry contexts' fingerprint, folded with each
        # step's configuration (not computed with the cache off).
        chain = ""
        if self.use_cache:
            chain = fingerprint_context(context)
            if val_context is not None:
                chain += fingerprint_context(val_context)
        for step_name, component in self._steps:
            print(f"Starting step {step_name}")
            t0 = time.perf_counter()
            if self.use_cache:
                chain = hashlib.sha256(
                    f"{chain}|{type(component).__name__}|{component.cache_token()}".encode()
                ).hexdigest()[:16]
            cache_file = (
                self._cache_path(step_name, component, chain) if self.use_cache and component.cacheable else None
            )
            hit = cache_file is not None and cache_file.is_file()
            if hit:
                with open(cache_file, "rb") as f:
                    loaded = pickle.load(f)
                context = loaded["context"]
                val_context = loaded["val_context"]
            else:
                check_req_keys(component.required_keys, context)
                if training:
                    check_req_keys(component.train_required_keys, context)
                    component.train(context, val_context)
                context = component.transform(context)
                if val_context is not None:
                    val_context = component.transform(val_context)
                if cache_file is not None:
                    # Renamed into place: the ranks of a mesh, which run the
                    # same pipeline, never read a half-written entry.
                    tmp = cache_file.with_name(f"{cache_file.name}.{os.getpid()}.tmp")
                    with open(tmp, "wb") as f:
                        pickle.dump({"context": context, "val_context": val_context}, f)
                    os.replace(tmp, cache_file)
            seconds = time.perf_counter() - t0
            self.step_log.append((step_name, seconds, hit))
            print(f"Completed step {step_name} in {seconds:.3f} s{' (cached)' if hit else ''}")
        return context, val_context

    def transform(self, context, val_context=None):
        return self._iterate(context, val_context, training=False)

    def train(self, context, val_context=None):
        return self._iterate(context, val_context, training=True)
