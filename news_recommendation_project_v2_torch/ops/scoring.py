"""The flat eval: user vectors from the flat history-token stream, cosine
scores of every candidate slot and, with a ``DeviceMetricsPlan``, the MIND
metrics, all on one device.

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

from ..config import TowerConfig
from ..data.grouping import truncate_flat_end_aligned
from ..device import resolve_device
from ..eval.device_metrics import DeviceMetricsPlan, metric_sums
from ..models.latent_attention import pool_epilogue
from ..utils.memory import estimate_flat_chunk

DEFAULT_FLAT_CHUNK = 64 * 1024
EPS = 1e-8  # cosine norm clamp


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

    def user_vectors(self, tower, query_table: torch.Tensor, normalize: bool) -> torch.Tensor:
        """[num_rows, D] float32: the tower per token, chunk by chunk, the
        segment-add, then the tower's own pool epilogue (the mean over
        ``max(len, 1)`` tokens and, if ``normalize``, the L2 norm)."""
        acc = torch.zeros(
            (self.num_rows + 1, tower.dim), dtype=torch.float32, device=query_table.device
        )
        for idx, rows, offsets in self.chunks:
            h = tower(query_table[idx][None], None)[0].float()
            acc.index_add_(0, rows, torch.segment_reduce(h, "sum", offsets=offsets, unsafe=True))
            # Gone before the next chunk's tower runs: at the eval's chunk
            # sizes one chunk's states are a gigabyte.
            del h
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
        cand_chunk: int = 1 << 18,
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
            u, c = user[cw], news[cr]
            nu = torch.linalg.vector_norm(u, dim=-1).clamp_min(EPS)
            nc = torch.linalg.vector_norm(c, dim=-1).clamp_min(EPS)
            out.copy_((u * c).sum(-1) / (nu * nc))
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
        return metrics_plan.finalize(metric_sums(full, metrics_plan.grids).tolist())


def score_all_impressions_flat(
    tower: torch.nn.Module,
    news_emb,
    hist_rev: np.ndarray,
    hist_lens: np.ndarray,
    cand_rev: np.ndarray,
    cand_row: np.ndarray,
    query_news_emb=None,
    chunk_tokens: int = DEFAULT_FLAT_CHUNK,
    cand_chunk: int = 1 << 18,
    max_len: Optional[int] = None,
    normalize: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """One-shot flat eval scores; a ``FlatEvalPlan`` kept across calls
    uploads its grids once."""
    plan = FlatEvalPlan(
        hist_rev, hist_lens, cand_rev, cand_row,
        chunk_tokens=chunk_tokens, cand_chunk=cand_chunk, max_len=max_len, device=device,
    )
    return plan.score(tower, news_emb, query_news_emb=query_news_emb, normalize=normalize)
