"""The id-keyed embedding dump, the store of per-token states and the
learned news encoder's pass over it.

- ``save_embeddings``/``load_embeddings``: ``{dataset}.npy`` [N, D],
  optional ``query_{dataset}.npy`` [N, D] and ``{dataset}_ids.npy`` [N] (the
  row -> news-id key), the files the JAX package's ``save_emb`` writes.
- ``TokenStore``: each news item's mask-trimmed token states packed into one
  flat [total_tokens, D] array with int64 offsets; its directory format
  (``states.npy``, ``offsets.npy``) is the JAX package's, byte for byte, so
  one store feeds both packages.
- ``materialize_from_token_store``: a learned token encoder over the whole
  store -> the [N, D] news embeddings, reading the states from the host or
  from a copy resident on the card.
"""

from __future__ import annotations

import dataclasses
import io
import sqlite3
from contextlib import closing
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import bucket_for_open
from ..device import resolve_device
from ..utils.inflight import InflightWindow
from ..utils.memory import estimate_token_attention_batch


def save_embeddings(
    save_dir: Path,
    dataset_name: str,
    embeddings: np.ndarray,
    query_embeddings: Optional[np.ndarray] = None,
    news_ids: Optional[np.ndarray] = None,
) -> None:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    np.save(save_dir / f"{dataset_name}.npy", np.asarray(embeddings))
    if query_embeddings is not None:
        np.save(save_dir / f"query_{dataset_name}.npy", np.asarray(query_embeddings))
    if news_ids is not None:
        np.save(save_dir / f"{dataset_name}_ids.npy", np.asarray(news_ids, dtype=np.str_))


def load_embeddings(save_dir: Path, dataset_name: str, with_query: bool = False):
    """``emb``, or ``(emb, query)`` with ``with_query`` (FileNotFoundError if
    the dump has no query table)."""
    save_dir = Path(save_dir)
    emb = np.load(save_dir / f"{dataset_name}.npy")
    if not with_query:
        return emb
    return emb, np.load(save_dir / f"query_{dataset_name}.npy")


# ---------------------------------------------------------------------------
# Token-state store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenStore:
    """Mask-trimmed per-news token states, packed flat: ``states``
    [total_tokens, D] (float32 or float16; a memmap when opened from disk)
    and ``offsets`` [num_news + 1] int64, news ``i``'s tokens being rows
    ``offsets[i]:offsets[i + 1]``."""

    states: np.ndarray
    offsets: np.ndarray

    @property
    def num_items(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def _lens(self, indices: np.ndarray, max_len: Optional[int]) -> tuple[np.ndarray, np.ndarray]:
        starts = self.offsets[indices]
        lens = (self.offsets[indices + 1] - starts).astype(np.int64)
        if max_len is not None:
            lens = np.minimum(lens, max_len)  # keep the FIRST max_len tokens
        return starts, lens

    def gather_padded(
        self, indices: np.ndarray, max_len: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """[len(indices), T, D] states in the store's type, zero-padded to the
        longest item T, and the [len(indices), T] float32 mask."""
        indices = np.asarray(indices)
        starts, lens = self._lens(indices, max_len)
        T = int(lens.max())
        out = np.zeros((len(indices), T, self.states.shape[1]), self.states.dtype)
        mask = np.zeros((len(indices), T), np.float32)
        # The per-item loop is the measured winner, not an oversight: each
        # item's tokens are contiguous, so this is B large memcpys; the
        # repeat/cumsum fancy-index form ran 1.4-1.9x slower at D=1024
        # (B=512/2048, a 65k-row store), as it becomes per-token row gathers
        # plus an indexed scatter.
        for j, (a, ln) in enumerate(zip(starts, lens)):
            out[j, :ln] = self.states[a : a + ln]
            mask[j, :ln] = 1.0
        return out, mask

    def padded_index_batch(
        self,
        indices: np.ndarray,
        T: int,
        out_rows: Optional[int] = None,
        max_len: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """The host half of a gather on the card: [M, T] int32 indices into
        the flat states' rows and the [M, T] float32 mask, M = ``out_rows``
        (default ``len(indices)``). Pad slots point at row 0 and are masked
        (the gather multiplies them away); pad rows past ``len(indices)`` keep
        mask slot 0 live, so masked reductions over them stay defined, as the
        host path's pad rows do."""
        indices = np.asarray(indices)
        M = len(indices) if out_rows is None else out_rows
        starts, lens = self._lens(indices, max_len)
        lens = np.minimum(lens, T)
        tok_idx = np.zeros((M, T), np.int32)
        mask = np.zeros((M, T), np.float32)
        ar = np.arange(T, dtype=np.int64)
        valid = ar[None, :] < lens[:, None]
        tok_idx[: len(indices)] = np.where(valid, starts[:, None] + ar[None, :], 0)
        mask[: len(indices)] = valid
        mask[len(indices) :, 0] = 1.0
        return tok_idx, mask

    def save(self, path: Path) -> None:
        """One ``.npz`` file (stores held in RAM); ``save_dir`` for stores
        read out of core."""
        np.savez(Path(path), states=self.states, offsets=self.offsets)

    @classmethod
    def load(cls, path: Path) -> "TokenStore":
        z = np.load(Path(path))
        return cls(states=z["states"], offsets=z["offsets"])

    def save_dir(self, path: Path) -> None:
        """The directory format, ``states.npy`` and ``offsets.npy``, which
        ``open_dir`` reopens as a memmap."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "states.npy", self.states)
        np.save(path / "offsets.npy", self.offsets)

    @classmethod
    def open_dir(cls, path: Path, mmap: bool = True) -> "TokenStore":
        """A directory-format store; with ``mmap`` the states stay on disk and
        a gather reads only the rows it asks for."""
        path = Path(path)
        states = np.load(path / "states.npy", mmap_mode="r" if mmap else None)
        return cls(states=states, offsets=np.load(path / "offsets.npy"))

    @classmethod
    def from_ragged(cls, arrays: list[np.ndarray]) -> "TokenStore":
        lens = np.array([len(a) for a in arrays], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        states = np.concatenate(arrays, axis=0) if arrays else np.zeros((0, 0), np.float32)
        return cls(states=states, offsets=offsets)

    @classmethod
    def from_reference_sqlite(
        cls, db_path: Path, out_dir: Optional[Path] = None, dtype=None
    ) -> "TokenStore":
        """Import the reference's SQLite token-state DB: a ``tensors(id
        INTEGER PRIMARY KEY, data BLOB)`` table of mask-trimmed
        ``torch.save``d [L_i, D] tensors, ids 1..N in corpus order. Each blob
        loads with ``torch.load(weights_only=True)``: tensors only, no code.

        With ``out_dir`` the import runs out of core: one pass over the DB
        for the lengths, a second filling a memmapped ``states.npy``, so a
        store larger than RAM imports in the memory of one blob; the result
        is ``open_dir(out_dir)``. Without it the states are assembled in RAM.
        ``dtype`` casts the states (``np.float16`` halves the store)."""
        db_path = Path(db_path)
        if not db_path.exists():
            raise FileNotFoundError(db_path)

        def rows(conn):
            expect = 1
            for rowid, blob in conn.execute("SELECT id, data FROM tensors ORDER BY id"):
                if rowid != expect:
                    raise ValueError(
                        f"reference token DB has non-contiguous ids (expected {expect}, got {rowid}); "
                        "ids must be the implicit 1..N rowids the reference writes"
                    )
                expect += 1
                with io.BytesIO(blob) as f:
                    yield torch.load(f, map_location="cpu", weights_only=True).float().numpy()

        # closing(): sqlite3's own context manager commits but does not close.
        with closing(sqlite3.connect(db_path)) as conn:
            if out_dir is None:
                arrays = [a if dtype is None else a.astype(dtype) for a in rows(conn)]
                if not arrays:
                    raise ValueError(f"token DB {db_path} is empty")
                return cls.from_ragged(arrays)
            lens, dim = [], None
            for a in rows(conn):
                lens.append(len(a))
                if dim is None:
                    dim, out_dtype = a.shape[1], np.dtype(dtype or a.dtype)
                elif a.shape[1] != dim:
                    raise ValueError(f"inconsistent hidden dim in token DB: {a.shape[1]} vs {dim}")
            if dim is None:
                raise ValueError(f"token DB {db_path} is empty")
            offsets = np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64))])
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            states = np.lib.format.open_memmap(
                out_dir / "states.npy", mode="w+", dtype=out_dtype, shape=(int(offsets[-1]), dim)
            )
            for i, a in enumerate(rows(conn)):
                states[offsets[i] : offsets[i + 1]] = a
            states.flush()
            del states
            # offsets.npy goes last: an interrupted import must not leave a
            # directory that open_dir loads as a complete, zero-filled store.
            np.save(out_dir / "offsets.npy", offsets)
        return cls.open_dir(out_dir)


def materialize_from_token_store(
    token_encoder: torch.nn.Module,
    store: TokenStore,
    batch_size: Optional[int] = 64,
    max_token_len: int = 512,
    token_buckets: tuple[int, ...] = (64, 128, 256, 512),
    dev_states: Optional[torch.Tensor] = None,
    device=None,
) -> np.ndarray:
    """The learned ``token_encoder`` ([B, T, D], [B, T] -> [B, D]) over every
    item of ``store``, dropout off -> the [N, D] float32 news embeddings.

    Batches of ``batch_size`` items (``None``: the memory model's
    ``estimate_token_attention_batch``, at most 1,024 and no more than the
    store rounded up to a power of two), the first ``max_token_len`` tokens of
    each, padded to the ``token_buckets`` bucket of the batch's longest
    (``bucket_for_open``) and to ``batch_size`` rows (pad rows keep mask slot
    0 live and are dropped). Two routes: with ``dev_states`` (the store's
    flat states resident on the card, in their own type) each batch uploads
    its [B, T] index grid and gathers on the card; without, each batch's
    [B, T, D] block is gathered on the host, pinned and copied without
    blocking. Up to 4 batches (the device route) or 1 (the host route,
    whose blocks each hold B x T x D states) stay in flight before the
    oldest one's result is fetched. ``device=None`` means CUDA."""
    device = resolve_device(device)
    n = store.num_items
    if batch_size is None:
        batch_size = min(
            1024,
            max(8, 1 << max(0, int(n) - 1).bit_length()),
            estimate_token_attention_batch(int(store.states.shape[1]), max_token_len, device=device),
        )
    out: list[np.ndarray] = []
    window = InflightWindow(
        4 if dev_states is not None else 1, lambda item: out.append(item[0][: item[1]].cpu().numpy())
    )
    with torch.no_grad():
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            if dev_states is not None:
                lens = np.minimum(store.offsets[idx + 1] - store.offsets[idx], max_token_len)
                T = bucket_for_open(int(lens.max()), token_buckets)
                tok_idx, mask = store.padded_index_batch(idx, T, out_rows=batch_size, max_len=max_token_len)
                tok_idx, mask = _to_device((tok_idx, mask), device)
                states = gathered_token_states(dev_states, tok_idx, mask)
            else:
                states, mask = store.gather_padded(idx, max_len=max_token_len)
                T = bucket_for_open(states.shape[1], token_buckets)
                states = np.pad(states, ((0, batch_size - len(idx)), (0, max(0, T - states.shape[1])), (0, 0)))
                mask = np.pad(mask, ((0, batch_size - len(idx)), (0, max(0, T - mask.shape[1]))))
                mask[len(idx) :, 0] = 1.0  # keep pad rows non-degenerate
                states, mask = _to_device((states, mask), device)
                states = states.float()
            window.push((token_encoder(states, mask).float(), len(idx)))
        window.flush()
    return np.concatenate(out)


def gathered_token_states(flat_states: torch.Tensor, tok_idx: torch.Tensor, tok_mask: torch.Tensor) -> torch.Tensor:
    """A batch's [M, T, D] float32 token states gathered from the flat store
    on the card (``flat_states`` in its own type; pad slots, which point at
    row 0, multiplied away by the mask)."""
    return flat_states[tok_idx.long()].float() * tok_mask[..., None]


def _to_device(arrays: tuple, device: torch.device) -> tuple:
    """Host arrays on ``device``: pinned and copied without blocking on CUDA."""
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if device.type != "cuda":
        return tensors
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
