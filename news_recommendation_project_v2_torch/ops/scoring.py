"""The eval's scoring: user vectors from the histories, then the cosine
score of every candidate slot, on one device. Two paths compute the user
vectors.

The bucketed (padded) path serves every tower: each row's history, end
aligned (its most recent clicks), is padded to the smallest of
``HISTORY_BUCKETS`` that holds it, and the tower runs over fixed-size
[batch, bucket] blocks (``_bucket_plan``), so it sees a small fixed set of
shapes. The user vectors go into a [rows, D] float32 matrix on the device by
``index_copy_`` on distinct rows, so two runs give the same bits.

The flat path, with ``FlatEvalPlan`` and, with a ``DeviceMetricsPlan``, the
MIND metrics on the device, serves token-local towers
(``models.supports_flat_scoring``).

The latent tower is token-local: each history token attends only to the 64
shared latents, and the LayerNorms, the GEGLU and the residuals are per
token, so the only cross-token step is the final mean-pool. The tower
therefore runs over the flat token stream in fixed-size chunks with no
padding inside a row, and the pool is a sorted segment-add into a per-row
accumulator. On CUDA every chunk goes through both hand-written kernels
(``ops.latent_attention``, ``ops.geglu``).

The segment-add is deterministic: within a chunk each row's tokens are summed
in order (``torch.segment_reduce`` over the row's contiguous run), and each
row takes one add per chunk (``index_add_`` over distinct rows), so two runs
give the same bits. A row's tokens may straddle two chunks; the pad tokens
that fill the last chunk go to a scratch row that is sliced off.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import HISTORY_BUCKETS, TowerConfig
from ..data.grouping import lengths_to_offsets, truncate_flat_end_aligned
from ..device import resolve_device
from ..eval.device_metrics import DeviceMetricsPlan, metric_sums
from ..models.latent_attention import pool_epilogue
from ..utils import profiling
from ..utils.memory import estimate_flat_chunk

DEFAULT_FLAT_CHUNK = 64 * 1024
COSINE_CHUNK = 1 << 18  # candidate slots a cosine pass gathers at once
EPS = 1e-8  # cosine norm clamp


def _cosine(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine, each norm clamped at ``EPS``
    (``torch.nn.functional.cosine_similarity``'s semantics)."""
    nu = torch.linalg.vector_norm(u, dim=-1).clamp_min(EPS)
    nc = torch.linalg.vector_norm(c, dim=-1).clamp_min(EPS)
    return (u * c).sum(-1) / (nu * nc)


@torch.inference_mode()
def cosine_scores_chunked(
    user_vecs: torch.Tensor,
    news_emb: torch.Tensor,
    cand_rev: np.ndarray,
    cand_row: np.ndarray,
) -> np.ndarray:
    """[C] float32 cosine scores of ``user_vecs[cand_row]`` against
    ``news_emb[cand_rev]`` on the user vectors' device, ``COSINE_CHUNK``
    slots at a time (the gathered [chunk, D] blocks bound the memory),
    fetched once."""
    device, chunk = user_vecs.device, COSINE_CHUNK
    out = torch.empty(len(cand_rev), dtype=torch.float32, device=device)
    for a in range(0, len(cand_rev), chunk):
        cr = _upload(np.asarray(cand_rev[a : a + chunk], np.int64), device)
        cw = _upload(np.asarray(cand_row[a : a + chunk], np.int64), device)
        out[a : a + chunk] = _cosine(user_vecs[cw], news_emb[cr])
    return out.cpu().numpy()


@torch.inference_mode()
def cosine_scores_flat(user_vecs, news_emb, cand_rev, cand_row, eps: float = EPS) -> torch.Tensor:
    """[C] cosine scores of ``user_vecs[cand_row]`` against
    ``news_emb[cand_rev]`` (each norm clamped at ``eps``), on the user
    vectors' device in one pass; ``cosine_scores_chunked`` bounds the memory
    and fetches to the host."""
    user_vecs = torch.as_tensor(user_vecs)
    news = torch.as_tensor(news_emb, device=user_vecs.device)
    u = user_vecs[torch.as_tensor(cand_row, device=user_vecs.device).long()]
    c = news[torch.as_tensor(cand_rev, device=user_vecs.device).long()]
    nu = torch.linalg.vector_norm(u, dim=-1).clamp_min(eps)
    nc = torch.linalg.vector_norm(c, dim=-1).clamp_min(eps)
    return (u * c).sum(-1) / (nu * nc)


def _bucket_plan(hist_lens: np.ndarray, buckets: tuple[int, ...], batch_size: int):
    """The padded path's host plan: per bucket that holds rows,
    ``(bucket_len, batch, starts, lens, rows)``, the arrays padded to a
    whole number of batches. ``batch`` is ``batch_size`` rounded down to a
    multiple of 8 (at least 8). A row keeps its most recent ``bucket_len``
    clicks (``starts`` end-aligned); pad entries have length 0 and the row
    ``len(hist_lens)``."""
    offsets = lengths_to_offsets(hist_lens)
    bucket_arr = np.asarray(buckets)
    bucket_ids = np.searchsorted(bucket_arr, np.minimum(hist_lens, bucket_arr[-1]))
    plan = []
    for bid in np.unique(bucket_ids):
        bucket_len = int(bucket_arr[bid])
        rows = np.flatnonzero(bucket_ids == bid).astype(np.int32)
        batch = max(8, batch_size // 8 * 8)
        n_pad = -(-len(rows) // batch) * batch
        pad = n_pad - len(rows)
        lens_capped = np.minimum(hist_lens[rows], bucket_len).astype(np.int64)
        starts = np.pad((offsets[rows + 1] - lens_capped).astype(np.int32), (0, pad))
        lens = np.pad(lens_capped.astype(np.int32), (0, pad))
        rows_padded = np.pad(rows, (0, pad), constant_values=len(hist_lens))
        plan.append((bucket_len, batch, starts, lens, rows_padded))
    return plan


@torch.inference_mode()
def user_vectors_device(
    tower,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    batch_size: int = 512,
    buckets: tuple[int, ...] = HISTORY_BUCKETS,
    device=None,
) -> torch.Tensor:
    """[num_rows, D] float32 user vectors on the device, by the bucketed
    path. ``news_emb`` is the table the histories are read from: the query
    table where the caller has one (``score_all_impressions`` passes its
    ``query_news_emb``). ``tower(gathered [B, L, D], mask [B, L])`` returns
    [B, D] (D the table's width, as ``models.check_tower_input_dim``
    requires); it is
    called on full [batch, bucket] blocks, pad rows included (length 0, all
    masked), whose outputs are dropped. The flat history indices are
    uploaded once, and each bucket's starts, lengths and rows once."""
    device = resolve_device(device)
    table = torch.as_tensor(news_emb, device=device)
    num_rows = len(hist_lens)
    hist = _upload(np.asarray(hist_rev, np.int64), device)
    limit = max(len(hist_rev) - 1, 0)
    user = torch.zeros((num_rows, table.shape[-1]), dtype=torch.float32, device=device)
    for bucket_len, batch, starts, lens, rows in _bucket_plan(hist_lens, buckets, batch_size):
        pos = torch.arange(bucket_len, device=device)
        starts_d, lens_d = _upload(starts.astype(np.int64), device), _upload(lens.astype(np.int64), device)
        real = int((rows < num_rows).sum())  # pad entries sit at the end
        rows_d = _upload(rows[:real].astype(np.int64), device)
        for a in range(0, real, batch):
            s, l = starts_d[a : a + batch], lens_d[a : a + batch]
            mask = (pos < l[:, None]).to(table.dtype)
            gathered = table[hist[(s[:, None] + pos).clamp_max(limit)]] * mask[..., None]
            out = tower(gathered, mask)
            k = min(batch, real - a)
            user.index_copy_(0, rows_d[a : a + k], out[:k].float())
    return user


def user_vectors_bucketed(
    tower,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    batch_size: int = 512,
    buckets: tuple[int, ...] = HISTORY_BUCKETS,
    device=None,
) -> np.ndarray:
    """``user_vectors_device`` fetched to the host, as float32 (``news_emb``
    is the history table, as there)."""
    return user_vectors_device(tower, news_emb, hist_rev, hist_lens, batch_size, buckets, device).cpu().numpy()


def score_all_impressions(
    tower,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    cand_rev: np.ndarray,
    cand_row: np.ndarray,
    query_news_emb=None,
    batch_size: int = 512,
    buckets: tuple[int, ...] = HISTORY_BUCKETS,
    flat_tokens: bool = False,
    flat_max_len: Optional[int] = None,
    mesh=None,
    device=None,
) -> np.ndarray:
    """The eval's scores: the tower over the histories, read from
    ``query_news_emb`` (e5's query-instruction table; ``None``:
    ``news_emb``), then the cosine of every candidate slot against
    ``news_emb``. ``cand_row`` indexes the rows of ``hist_lens`` (the caller
    has kept only the with-history rows' slots).

    The bucketed path by default; ``flat_tokens=True`` takes the flat path
    (a one-shot ``FlatEvalPlan``; token-local towers only), in the token
    chunks ``_auto_flat_chunk`` picks, with ``flat_max_len`` capping each row
    at its most recent clicks, as the largest bucket caps the bucketed path.
    ``device=None`` means CUDA.

    With a ``mesh`` (``parallel.mesh.Mesh``; every rank calls this with the
    same arguments), the rows are cut by token count into one contiguous
    part per rank (``parallel.flat_eval.partition_rows_by_tokens``); each
    rank computes the user vectors of its part, the ``[rows, D]`` matrix is
    summed over the mesh with zeros where a rank has no row (exact), and
    every rank scores every slot and returns the same scores."""
    if len(hist_lens) and np.asarray(cand_row).max() >= len(hist_lens):
        raise ValueError("cand_row indexes rows beyond hist_lens")
    device = resolve_device(device)
    news = torch.as_tensor(news_emb, device=device)
    query = news if query_news_emb is None else torch.as_tensor(query_news_emb, device=device)
    hist_rev, hist_lens = np.asarray(hist_rev), np.asarray(hist_lens)
    rows = slice(0, len(hist_lens))
    if mesh is not None:
        from ..parallel.flat_eval import partition_rows_by_tokens

        capped = hist_lens if not flat_tokens or flat_max_len is None else np.minimum(hist_lens, flat_max_len)
        bounds = partition_rows_by_tokens(capped, mesh.size)
        rows = slice(int(bounds[mesh.rank]), int(bounds[mesh.rank + 1]))
    offsets = lengths_to_offsets(hist_lens)
    part_rev, part_lens = hist_rev[offsets[rows.start] : offsets[rows.stop]], hist_lens[rows]
    if flat_tokens:
        tokens = int((part_lens if flat_max_len is None else np.minimum(part_lens, flat_max_len)).sum())
        if mesh is None:
            plan = FlatEvalPlan(
                hist_rev, hist_lens, cand_rev, cand_row,
                chunk_tokens=_auto_flat_chunk(tower.dim, tokens, device), max_len=flat_max_len, device=device,
            )
            return plan.score(tower, news, query)
        part = user_vectors_flat(
            tower, query, part_rev, part_lens, _auto_flat_chunk(tower.dim, tokens, device), flat_max_len, device=device
        )
    else:
        part = user_vectors_device(tower, query, part_rev, part_lens, batch_size, buckets, device)
    if mesh is None:
        return cosine_scores_chunked(part, news, cand_rev, cand_row)
    user = torch.zeros((len(hist_lens), part.shape[-1]), dtype=torch.float32, device=device)
    user[rows] = part
    return cosine_scores_chunked(mesh.sum(user), news, cand_rev, cand_row)


def _auto_flat_chunk(out_dim: int, num_tokens: int, device) -> int:
    """The flat eval's token chunk when the caller gives none: the memory
    model's (``utils.memory.estimate_flat_chunk``, a quarter of the device's
    memory) for the latent geometry scaled to ``out_dim``, the only
    flat-capable tower family; but no larger than ``num_tokens`` rounded up
    to a power of two (at least 1,024), since a chunk past the data is all
    pad."""
    cfg = TowerConfig(
        kind="latent",
        reduced_dim=out_dim,
        num_latents=min(64, out_dim),
        latent_dim_head=max(8, out_dim // 2),
    )
    data = max(1024, 1 << max(int(num_tokens) - 1, 0).bit_length())
    return min(estimate_flat_chunk(cfg, device=device), data)


def _pad_to_grid(arr: np.ndarray, chunk: int, fill) -> np.ndarray:
    """Pad a flat host array to a whole number of ``chunk``-sized rows and
    reshape to [n_chunks, chunk]."""
    n_chunks = max(1, -(-len(arr) // chunk))
    padded = np.full(n_chunks * chunk, fill, dtype=arr.dtype)
    padded[: len(arr)] = arr
    return padded.reshape(n_chunks, chunk)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` (the current card) matches ``cuda:<n>``."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _check_tower(tower: torch.nn.Module, device: torch.device, normalize: Optional[bool]) -> bool:
    """The tower's ``output_normalize`` (``normalize``, where given, must
    equal it), after checking the tower lies on ``device``."""
    where = next(tower.parameters()).device
    if not _same_device(where, device):
        raise ValueError(f"the tower lies on {where}, the plan on {device}")
    if normalize is not None and normalize != tower.output_normalize:
        raise ValueError(
            f"normalize={normalize} but the tower's output_normalize is "
            f"{tower.output_normalize}; the flat pool must end as the tower's does"
        )
    return tower.output_normalize


class _HistoryChunks:
    """The flat history tokens of ``num_rows`` rows in chunks of
    ``chunk_tokens``, on the device: per chunk the news rows of its tokens
    (pad 0), the rows its tokens belong to (ascending, distinct; the pad
    tokens' row is ``num_rows``) and where each row's run starts."""

    def __init__(self, hist_rev, hist_lens, chunk_tokens: int, max_len: Optional[int], device):
        hist_lens = np.asarray(hist_lens)
        self.num_rows = len(hist_lens)
        idx = np.ascontiguousarray(np.asarray(hist_rev, dtype=np.int64))
        if max_len is not None:
            idx, lens_used = truncate_flat_end_aligned(idx, hist_lens, max_len)
        else:
            lens_used = hist_lens
        rows = np.repeat(np.arange(self.num_rows, dtype=np.int64), lens_used)
        self.chunks = []
        for i, r in zip(_pad_to_grid(idx, chunk_tokens, 0), _pad_to_grid(rows, chunk_tokens, self.num_rows)):
            starts = np.flatnonzero(np.concatenate([[True], r[1:] != r[:-1]]))
            self.chunks.append(
                tuple(_upload(a, device) for a in (i, r[starts], np.append(starts, len(r))))
            )
        self.lens = _upload(np.asarray(lens_used, dtype=np.float32), device)
        self.tokens_real = len(rows)
        self.tokens_computed = len(self.chunks) * chunk_tokens

    def user_vectors(self, tower, query_table: torch.Tensor, normalize: bool) -> torch.Tensor:
        """[num_rows, D] float32: the tower per token, chunk by chunk, the
        segment-add, then the tower's own pool epilogue (the mean over
        ``max(len, 1)`` tokens and, if ``normalize``, the L2 norm). Where it
        records (``utils.profiling``), a span ``eval.chunk`` each chunk, and
        the counters ``eval.tokens_real`` and ``eval.tokens_computed``."""
        acc = torch.zeros(
            (self.num_rows + 1, tower.dim), dtype=torch.float32, device=query_table.device
        )
        for idx, rows, offsets in self.chunks:
            with profiling.span("eval.chunk"):
                h = tower(query_table[idx][None], None)[0].float()
                acc.index_add_(0, rows, torch.segment_reduce(h, "sum", offsets=offsets, unsafe=True))
                # Gone before the next chunk's tower runs: at the eval's chunk
                # sizes one chunk's states are a gigabyte.
                del h
        profiling.count("eval.tokens_real", self.tokens_real)
        profiling.count("eval.tokens_computed", self.tokens_computed)
        return pool_epilogue(acc[: self.num_rows], self.lens, normalize)


@torch.inference_mode()
def user_vectors_flat(
    tower: torch.nn.Module,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    chunk_tokens: int = DEFAULT_FLAT_CHUNK,
    max_len: Optional[int] = None,
    normalize: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """[num_rows, D] float32 user vectors on the device, by the flat path.

    ``tower(tokens[None], None)`` must return the per-token states (the
    port's ``LatentAttentionTower`` with ``attention_mask=None``).
    ``max_len=None`` uses every history token; an int keeps the most recent
    ``max_len`` clicks of each row, as the bucketed path's cap does.
    """
    device = resolve_device(device)
    normalize = _check_tower(tower, device, normalize)
    grid = _HistoryChunks(hist_rev, hist_lens, chunk_tokens, max_len, device)
    return grid.user_vectors(tower, torch.as_tensor(news_emb, device=device), normalize)


class FlatEvalPlan:
    """Index grids of one dataset on one device, for repeated flat evals
    (every training epoch's eval, benchmarks): the history-token chunks and
    the candidate slots are uploaded once, and each ``score`` or ``metrics``
    call is the tower, the pool and the cosine over them.

    ``device=None`` means CUDA (``device.resolve_device``); on CUDA the tower
    must lie there too and runs through the hand-written kernels.
    """

    def __init__(
        self,
        hist_rev: np.ndarray,
        hist_lens: np.ndarray,
        cand_rev: np.ndarray,
        cand_row: np.ndarray,
        chunk_tokens: int = DEFAULT_FLAT_CHUNK,
        cand_chunk: int = COSINE_CHUNK,
        max_len: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.history = _HistoryChunks(hist_rev, hist_lens, chunk_tokens, max_len, self.device)
        self.num_slots = len(cand_rev)
        self.cand_rev2d = _upload(_pad_to_grid(np.asarray(cand_rev, np.int64), cand_chunk, 0), self.device)
        self.cand_row2d = _upload(_pad_to_grid(np.asarray(cand_row, np.int64), cand_chunk, 0), self.device)

    def _scores(self, tower, news_emb, query_news_emb, normalize) -> torch.Tensor:
        """[num_slots] float32 cosine scores on the device, with no host sync."""
        normalize = _check_tower(tower, self.device, normalize)
        news = torch.as_tensor(news_emb, device=self.device)
        query = news if query_news_emb is None else torch.as_tensor(query_news_emb, device=self.device)
        user = self.history.user_vectors(tower, query, normalize)
        scores = torch.empty(self.cand_rev2d.shape, dtype=torch.float32, device=self.device)
        for out, cr, cw in zip(scores, self.cand_rev2d, self.cand_row2d):
            out.copy_(_cosine(user[cw], news[cr]))
        return scores.reshape(-1)[: self.num_slots]

    @torch.inference_mode()
    def score(
        self,
        tower: torch.nn.Module,
        news_emb,
        query_news_emb=None,
        normalize: Optional[bool] = None,
    ) -> np.ndarray:
        """[num_slots] float32 cosine scores, fetched to the host.
        ``news_emb`` is the candidate table; ``query_news_emb`` (default: the
        same) is the table the tower reads, e.g. a bfloat16 copy for a
        bfloat16 tower while the cosine stays float32."""
        return self._scores(tower, news_emb, query_news_emb, normalize).cpu().numpy()

    @torch.inference_mode()
    def metrics(
        self,
        tower: torch.nn.Module,
        news_emb,
        metrics_plan: DeviceMetricsPlan,
        query_news_emb=None,
        normalize: Optional[bool] = None,
        alpha: Union[None, float, torch.Tensor] = None,
    ) -> dict[str, float]:
        """The whole eval on the device, one host sync: the tower pass, the
        cosine, the score composition and the MIND metrics of
        ``metrics_plan``; five scalars are fetched. The result equals
        ``eval.ranker.compose_final_scores(...).metrics``. ``alpha``
        overrides the plan's blend weight."""
        if not _same_device(metrics_plan.device, self.device):
            raise ValueError(f"the metrics plan lies on {metrics_plan.device}, this plan on {self.device}")
        full = metrics_plan.compose(self._scores(tower, news_emb, query_news_emb, normalize), alpha)
        with profiling.span("eval.fetch"):
            sums = metric_sums(full, metrics_plan.grids).tolist()
        return metrics_plan.finalize(sums)


def score_all_impressions_flat(
    tower: torch.nn.Module,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    cand_rev: np.ndarray,
    cand_row: np.ndarray,
    query_news_emb=None,
    chunk_tokens: int = DEFAULT_FLAT_CHUNK,
    cand_chunk: int = COSINE_CHUNK,
    max_len: Optional[int] = None,
    normalize: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """The flat eval's scores in one shot: a ``FlatEvalPlan`` built and
    scored once (build the plan directly to score one dataset many times).
    ``device=None`` means CUDA."""
    plan = FlatEvalPlan(
        hist_rev, hist_lens, cand_rev, cand_row,
        chunk_tokens=chunk_tokens, cand_chunk=cand_chunk, max_len=max_len, device=device,
    )
    return plan.score(tower, news_emb, query_news_emb=query_news_emb, normalize=normalize)
