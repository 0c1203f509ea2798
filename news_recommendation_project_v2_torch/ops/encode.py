"""Corpus encoding, the id-keyed embedding dump, the store of per-token
states and the learned news encoder's pass over it.

- ``encode_corpus`` / ``encode_corpus_bucketed``: a ``NewsEncoder`` over a
  tokenized corpus in batches of a fixed shape (the bucketed form groups the
  rows by token count into length buckets), the [N, D] vectors left on the
  card, a pool mask carried with the rows; ``encode_query_and_passage``:
  the two tables of e5 and NV-Embed, passage vectors of the raw text and
  query vectors of the instruction-prefixed text (NV-Embed's without the
  instruction's tokens in the pool). One such call is the unit
  ``encode.corpus`` of ``utils.profiling``: span ``encode.batch`` (a
  batch's copies and forward queued), counters ``encode.rows``,
  ``encode.tokens_real``, ``encode.tokens_computed`` (rows computed x
  width), ``encode.pad_rows`` (rows computed past the real ones) and
  ``encode.pool_tokens``.
- ``build_token_store``: the encoder's per-token states, mask-trimmed, into
  a ``TokenStore`` in RAM or streamed into a memmapped directory.
- ``save_embeddings``/``load_embeddings``: ``{dataset}.npy`` [N, D],
  optional ``query_{dataset}.npy`` [N, D] and ``{dataset}_ids.npy`` [N] (the
  row -> news-id key), the files the JAX package's ``save_emb`` writes.
- ``TokenStore``: each news item's mask-trimmed token states packed into one
  flat [total_tokens, D] array with int64 offsets; its directory format
  (``states.npy``, ``offsets.npy``) is the JAX package's, byte for byte, so
  one store feeds both packages.
- ``materialize_from_token_store``: a learned token encoder over the whole
  store -> the [N, D] news embeddings, reading the states from the host or
  from a copy resident on the card; ``materialize_from_token_store_mesh``
  the same over a mesh of ranks, from a resident copy on every rank or a
  ``parallel.sharding.ShardedStore``.
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
from ..utils import profiling
from ..utils.inflight import InflightWindow
from ..utils.memory import estimate_encoder_batch, estimate_token_attention_batch


# Length buckets of a corpus encode: MIND's title-only news are about 15-30
# tokens, so most rows run 32 wide instead of the tokenizer's full width;
# whole articles (about 850 tokens, to 4,096) take the wide ones. Only the
# buckets narrower than a call's width apply.
TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# A bucket whose one batch holds at most this many tokens (rows x width) is
# encoded on a side stream on the card. Such a batch launches as many kernels
# as a full one for almost no work: queued behind a wide bucket on the same
# stream, its launches wait for that bucket to drain and then pace the card
# (Moonlight's 16-row and 8-row buckets on an H100: ~60 ms idle each).
SIDE_STREAM_TOKENS = 8192


def _auto_batch(encoder, width: int, device: torch.device) -> int:
    """The memory model's batch at ``width`` tokens, capped at about 131,072
    tokens a batch (at least 1,024 rows)."""
    return min(max(1024, 131072 // width), estimate_encoder_batch(encoder.config, length=width, device=device))


def _even_batch(n: int, cap: int) -> int:
    """The rows of each batch when ``n`` rows split evenly over the fewest
    batches of at most ``cap`` rows (one batch for no rows): their share,
    rounded up to a multiple of 8 and at most ``cap``. So a call computes
    ``ceil(n / cap)`` batches of one shape, and fewer than 8 pad rows a batch
    where ``cap`` is a multiple of 8."""
    batches = max(1, -(-n // cap))
    share = -(-max(n, 1) // batches)
    return min(cap, -(-share // 8) * 8)


@profiling.unit("encode.corpus")
def encode_corpus(
    encoder: torch.nn.Module,
    token_ids: np.ndarray,
    token_mask: np.ndarray,
    batch_size: Optional[int] = 256,
    device=None,
    pool_mask: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """``encoder`` ([B, T] ids and mask -> [B, D]) over a tokenized corpus
    [N, T] -> the [N, D] float32 vectors on ``device`` (``None``: CUDA;
    the encoder must lie there). ``batch_size`` caps a batch's rows: the N
    rows split evenly over the fewest batches it allows (``_even_batch``),
    all of one [B, T] shape, B at most ``batch_size``; rows past N are
    padding with mask slot 0 live, so no row is all pad, and are dropped;
    an empty corpus runs one pad batch and gives [0, D].
    ``batch_size=None`` takes the memory model's batch for the encoder's
    ``config`` (``estimate_encoder_batch``) at T, capped at about 131,072
    tokens a batch. ``pool_mask`` [N, T] goes to the encoder as its
    third argument, batch by batch (the tokens its pool takes; ``None``: the
    encoder pools over ``token_mask``). Each batch's arrays go to the card
    from pinned memory; up to 2 batches stay in flight before the oldest is
    written into the result. An encoder that routes tokens to experts
    (``routes_tokens``, the ``deepseek_v3`` layout) is handed each batch's
    count of real tokens from the host mask, so it never waits for the
    device to count them."""
    device = resolve_device(device)
    n, width = token_ids.shape
    if batch_size is None:
        batch_size = _auto_batch(encoder, width, device)
    batch_size = _even_batch(n, batch_size)
    n_pad = max(batch_size, -(-n // batch_size) * batch_size)
    arrays = [token_ids, token_mask] + ([] if pool_mask is None else [pool_mask])
    arrays = [np.pad(a, ((0, n_pad - n), (0, 0))) for a in arrays]
    for a in arrays[1:]:
        a[n:, 0] = 1
    if profiling.active():
        profiling.count("encode.rows", n)
        profiling.count("encode.tokens_real", int(np.asarray(token_mask).sum()))
        profiling.count("encode.tokens_computed", n_pad * width)
        profiling.count("encode.pad_rows", n_pad - n)
        profiling.count("encode.pool_tokens", int(np.asarray(token_mask if pool_mask is None else pool_mask).sum()))
    out: Optional[torch.Tensor] = None
    window = InflightWindow(2, lambda item: out[item[0] : item[0] + len(item[1])].copy_(item[1]))
    routes = getattr(encoder, "routes_tokens", False)
    with torch.no_grad():
        for start in range(0, n_pad, batch_size):
            with profiling.span("encode.batch"):
                host = tuple(a[start : start + batch_size] for a in arrays)
                batch = _to_device(host, device)
                extra = {"real_tokens": int(host[1].sum())} if routes else {}
                emb = encoder(*batch, **extra).float()
            if out is None:
                out = torch.empty((n_pad, emb.shape[1]), dtype=torch.float32, device=device)
            window.push((start, emb))
        window.flush()
    return out[:n]


@profiling.unit("encode.corpus")
def encode_corpus_bucketed(
    encoder: torch.nn.Module,
    token_ids: np.ndarray,
    token_mask: np.ndarray,
    buckets: tuple[int, ...] = TOKEN_BUCKETS,
    batch_size: Optional[int] = None,
    device=None,
    pool_mask: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """``encode_corpus`` by length bucket: each row runs at the narrowest of
    ``buckets`` (and T, always the last) that holds its tokens, so short
    news never pay for the full width; the rows' vectors are written back
    by index into one [N, D] float32 tensor on the card. A padded key adds
    exactly nothing to a masked softmax, so each row equals the fixed-width
    encode up to the order of float sums. A bucket's rows split evenly over
    the fewest batches that ``batch_size``, or the memory model's batch at
    its width (``None``), allows. ``pool_mask`` goes with its rows,
    cut to their bucket. The host never waits for the device here: the
    next bucket's batches queue behind the last one's (on the card a
    pageable copy of the row index would wait for all of them, and a short
    bucket's launches would then pace the card), and a bucket of one small
    batch (``SIDE_STREAM_TOKENS``) runs beside them on a side stream. Those
    buckets are queued right behind the bucket of the most tokens a batch,
    so the card has its long kernels to run while the host launches theirs:
    queued before any wide work (whole articles' narrowest buckets), they
    would be paced by the host, and queued last, their last launches
    would."""
    device = resolve_device(device)
    n, width = token_ids.shape
    if n == 0:
        return encode_corpus(encoder, token_ids, token_mask, batch_size or 8, device, pool_mask)
    lengths = np.asarray(token_mask).sum(axis=1).astype(np.int64)
    widths = tuple(sorted({int(b) for b in buckets if 0 < b < width})) + (width,)
    assignment = np.searchsorted(np.asarray(widths), lengths, side="left")
    plan = []
    for bi, w in enumerate(widths):
        rows = np.nonzero(assignment == bi)[0]
        if len(rows):
            bs = _even_batch(len(rows), batch_size or _auto_batch(encoder, w, device))
            side = device.type == "cuda" and len(rows) <= bs and bs * w <= SIDE_STREAM_TOKENS
            plan.append((side, w, rows, bs))
    wide = [p for p in plan if not p[0]]
    if wide:  # the side stream's buckets right behind the bucket of the longest batches
        at = max(range(len(wide)), key=lambda i: wide[i][1] * wide[i][3]) + 1
        plan = wide[:at] + [p for p in plan if p[0]] + wide[at:]
    out: Optional[torch.Tensor] = None
    for side, w, rows, bs in plan:
        ids, mask, pool = (
            None if a is None else np.ascontiguousarray(a[rows, :w]) for a in (token_ids, token_mask, pool_mask)
        )
        if side:
            emb = _on_side_stream(lambda: encode_corpus(encoder, ids, mask, bs, device, pool), device)
        else:
            emb = encode_corpus(encoder, ids, mask, bs, device, pool)
        if out is None:
            out = torch.zeros((n, emb.shape[1]), dtype=torch.float32, device=device)
        (index,) = _to_device((rows,), device)
        out.index_copy_(0, index, emb)
    return out


def _on_side_stream(fn, device: torch.device) -> torch.Tensor:
    """``fn()``'s tensor, its work queued on a side stream of ``device`` that
    runs beside the current one; the current stream waits for it before
    its next work, and holds its memory."""
    main = torch.cuda.current_stream(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    side = _SIDE_STREAMS.get(index)
    if side is None:
        side = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    out.record_stream(main)
    return out


_SIDE_STREAMS: dict = {}


def instruction_pool_mask(tokenize, instruction: str, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``mask`` of instruction-prefixed rows with each row's instruction out:
    the leading tokens a row shares with ``instruction`` tokenized alone
    (its BOS and the instruction's tokens; the closing token of the
    instruction alone meets the text's first and ends the match, as does a
    token the text merges with the instruction's last)."""
    i_ids, i_mask = tokenize([instruction])
    k = min(int(np.asarray(i_mask)[0].sum()), ids.shape[1])
    prefix = np.cumprod(ids[:, :k] == np.asarray(i_ids)[0, :k], axis=1).sum(axis=1)
    return np.where(np.arange(ids.shape[1])[None, :] < prefix[:, None], 0, mask).astype(mask.dtype)


@profiling.unit("encode.corpus")
def encode_query_and_passage(
    encoder: torch.nn.Module,
    tokenize,
    texts: list[str],
    query_instruction: str,
    batch_size: Optional[int] = 256,
    buckets: Optional[tuple[int, ...]] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two tables of ``texts``: ``(query, passage)``, each [N, D] on the
    card. Passage vectors encode the raw text, query vectors
    ``query_instruction + text``. An encoder with NV-Embed's latent-pool
    head (``config.latent_pool``) leaves the instruction's tokens out of the
    query rows' pool (``instruction_pool_mask``), as NV-Embed does; they
    still reach the other tokens through attention. e5 pools them. Passage
    rows pool every real token. ``tokenize`` maps a list of texts to (ids,
    mask) arrays; ``buckets`` runs ``encode_corpus_bucketed``, else
    ``encode_corpus``. The passage rows are queued before the query rows
    are tokenized, so the card encodes while the host tokenizes."""
    ids, mask = tokenize(texts)
    if buckets is not None:
        passage = encode_corpus_bucketed(encoder, ids, mask, buckets, batch_size, device)
    else:
        passage = encode_corpus(encoder, ids, mask, batch_size, device)
    q_ids, q_mask = tokenize([query_instruction + t for t in texts])
    q_pool = None
    if getattr(getattr(encoder, "config", None), "latent_pool", False):
        q_pool = instruction_pool_mask(tokenize, query_instruction, q_ids, q_mask)
    if buckets is not None:
        query = encode_corpus_bucketed(encoder, q_ids, q_mask, buckets, batch_size, device, q_pool)
    else:
        query = encode_corpus(encoder, q_ids, q_mask, batch_size, device, q_pool)
    return query, passage


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


def load_embeddings(
    save_dir: Path,
    dataset_name: str,
    with_query: bool = False,
    align_to_news_ids: Optional[np.ndarray] = None,
):
    """``emb``, or ``(emb, query)`` with ``with_query`` (FileNotFoundError if
    the dump has no query table).

    With ``align_to_news_ids`` the rows are reordered to that news-id order
    through the dump's id key (``{dataset}_ids.npy``), so a dump written for
    one run's rows serves another's: ``FileNotFoundError`` if the dump has no
    id key, ``KeyError`` naming the first id the dump lacks."""
    save_dir = Path(save_dir)
    emb = np.load(save_dir / f"{dataset_name}.npy")
    query = np.load(save_dir / f"query_{dataset_name}.npy") if with_query else None
    if align_to_news_ids is not None:
        ids_path = save_dir / f"{dataset_name}_ids.npy"
        if not ids_path.exists():
            raise FileNotFoundError(
                f"{ids_path} missing: this dump is positional-only and cannot "
                "be realigned; re-run save_emb to write the id key"
            )
        row_of = {str(n): i for i, n in enumerate(np.load(ids_path))}
        try:
            order = np.array([row_of[str(n)] for n in align_to_news_ids], dtype=np.int64)
        except KeyError as e:
            raise KeyError(f"news id {e.args[0]!r} not present in embedding dump {dataset_name!r}") from None
        emb = emb[order]
        if query is not None:
            query = query[order]
    if not with_query:
        return emb
    return emb, query


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


def build_token_store(
    encoder: torch.nn.Module,
    token_ids: np.ndarray,
    token_mask: np.ndarray,
    batch_size: int = 64,
    out_dir: Optional[Path] = None,
    store_dtype=np.float32,
    token_buckets: Optional[tuple[int, ...]] = TOKEN_BUCKETS,
    device=None,
) -> TokenStore:
    """The encoder's per-token states (``encoder.hidden_states``, no pool),
    each row trimmed to its mask, as a ``TokenStore`` of ``store_dtype``
    (``np.float16`` halves it).

    Rows run in batches of ``batch_size`` in bucket order (``token_buckets``
    as in ``encode_corpus_bucketed``, each batch at its longest row's
    bucket; ``None``: one pass at full width, in corpus order); pad rows are
    all pad. With ``out_dir`` the states stream into a ``states.npy`` memmap
    preallocated at the size the mask gives, ``offsets.npy`` is written last
    (an interrupted build leaves no directory that opens as a store), and the
    store comes back opened read-only from disk; without it the store is
    assembled in RAM. One batch of [B, T, D] float32 states stays in flight
    on the card while the one before it is fetched and trimmed."""
    device = resolve_device(device)
    n, width = token_ids.shape
    lens = np.asarray(token_mask).sum(axis=1).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    if token_buckets is not None and n > 0:
        widths = tuple(sorted({int(b) for b in token_buckets if 0 < b < width})) + (width,)
        assignment = np.searchsorted(np.asarray(widths), lens, side="left")
        row_order = np.argsort(assignment, kind="stable")
        row_widths = np.asarray(widths)[assignment]
    else:
        row_order = np.arange(n)
        row_widths = np.full(n, width, np.int64)
    out_dir = None if out_dir is None else Path(out_dir)
    states: Optional[np.ndarray] = None  # the memmap, once D is known
    arrays: list[Optional[np.ndarray]] = [None] * n

    def consume(item) -> None:
        nonlocal states
        rows, dev = item
        hidden = dev.cpu().numpy()
        if out_dir is not None and states is None:
            out_dir.mkdir(parents=True, exist_ok=True)
            states = np.lib.format.open_memmap(
                out_dir / "states.npy", mode="w+", dtype=store_dtype, shape=(int(offsets[-1]), hidden.shape[-1])
            )
        for j, row in enumerate(rows):
            trimmed = hidden[j, : lens[row]].astype(store_dtype)
            if states is not None:
                states[offsets[row] : offsets[row + 1]] = trimmed
            else:
                arrays[row] = trimmed

    window = InflightWindow(1, consume)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            rows = row_order[start : start + batch_size]
            w = int(row_widths[rows].max())
            pad = batch_size - len(rows)
            ids = np.pad(np.ascontiguousarray(token_ids[rows, :w]), ((0, pad), (0, 0)))
            mask = np.pad(np.ascontiguousarray(token_mask[rows, :w]), ((0, pad), (0, 0)))
            window.push((rows, encoder.hidden_states(*_to_device((ids, mask), device))))
        window.flush()
    if out_dir is None:
        return TokenStore.from_ragged(arrays)
    if states is None:  # an empty corpus: a valid, empty store
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "states.npy", np.zeros((0, 1), np.float32))
    else:
        states.flush()
    np.save(out_dir / "offsets.npy", offsets)
    return TokenStore.open_dir(out_dir, mmap=True)


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
        batch_size = _default_materialize_batch(store, max_token_len, device)
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


def _default_materialize_batch(store: "TokenStore", max_token_len: int, device: torch.device) -> int:
    return min(
        1024,
        max(8, 1 << max(0, int(store.num_items) - 1).bit_length()),
        estimate_token_attention_batch(int(store.states.shape[1]), max_token_len, device=device),
    )


def materialize_from_token_store_mesh(
    token_encoder: torch.nn.Module,
    store: TokenStore,
    mesh,
    dev_states,
    batch_size: Optional[int] = None,
    max_token_len: int = 512,
    token_buckets: tuple[int, ...] = (64, 128, 256, 512),
    device=None,
) -> np.ndarray:
    """``materialize_from_token_store``'s resident route over a mesh of
    ranks (``parallel.mesh.Mesh``; every rank calls it alike): each chunk of
    ``batch_size`` items (rounded down to a multiple of the data axis, at
    least one item a data rank) splits its rows over the data axis, each
    data rank pools its share, reading the states from ``dev_states`` (the
    flat states resident on every rank) or from a
    ``parallel.sharding.ShardedStore``, and one ``all_gather`` over the data
    axis gives every rank the chunk; returns the [N, D] float32 embeddings
    on every rank. The model ranks of a data rank repeat its work.

    The JAX package's ``multiprocess`` and ``apply_cache`` arguments have no
    counterpart: they place arrays and cache jitted programs for XLA.
    ``device=None`` means CUDA."""
    from ..parallel.sharding import ShardedStore

    device = resolve_device(device)
    data = mesh.data_size
    if batch_size is None:
        batch_size = _default_materialize_batch(store, max_token_len, device)
    batch_size = max(data, (batch_size // data) * data)
    per = batch_size // data
    mine = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    sharded = isinstance(dev_states, ShardedStore)
    n = store.num_items
    out: list[np.ndarray] = []
    window = InflightWindow(4, lambda item: out.append(item[0][: item[1]].cpu().numpy()))
    with torch.no_grad():
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            lens = np.minimum(store.offsets[idx + 1] - store.offsets[idx], max_token_len)
            T = bucket_for_open(int(lens.max()), token_buckets)
            tok_idx, mask = store.padded_index_batch(idx, T, out_rows=batch_size, max_len=max_token_len)
            if sharded:
                grids, mask = _to_device((tok_idx.reshape(data, per, T), mask[mine]), device)
                states = dev_states.gather(grids).float() * mask[..., None]
            else:
                tok_idx, mask = _to_device((tok_idx[mine], mask[mine]), device)
                states = gathered_token_states(dev_states, tok_idx, mask)
            pooled = token_encoder(states, mask).float()
            window.push((torch.cat(mesh.all_gather(pooled, "data")), len(idx)))
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
