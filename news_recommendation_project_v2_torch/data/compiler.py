"""The behaviors compiler: MIND history/impression strings -> flat index arrays,
by the native extension (``native/behaviors_compiler.cpp``) where it builds,
else in numpy (no pandas); the two give equal arrays.

- ``news_ids``: unique news ids in first-appearance order, scanning each row's
  history tokens, then its impression tokens.
- ``imp_rev`` / ``imp_row``: for every impression slot, its index into
  ``news_ids`` and its owning row.
- ``hist_rev`` / ``hist_row``: the same for history slots. Rows without
  history own no history entry, so history row ids index the with-history
  subset in original order; ``hist_row_index`` maps that subset back to the
  original rows.
- ``labels_flat``: 0/1 click labels parsed from ``N1234-1`` tokens, aligned
  with ``imp_rev``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CompiledBehaviors:
    news_ids: np.ndarray  # [num_unique_news] str, first-appearance order
    imp_rev: np.ndarray  # [total_imp_slots] int32 index into news_ids
    imp_row: np.ndarray  # [total_imp_slots] int32 owning behaviors-row id
    imp_lens: np.ndarray  # [num_rows] int32
    hist_rev: np.ndarray  # [total_hist_slots] int32 index into news_ids
    hist_row: np.ndarray  # [total_hist_slots] int32 owning with-history-row id
    hist_lens: np.ndarray  # [num_hist_rows] int32
    hist_row_index: np.ndarray  # [num_hist_rows] int32 original row ids with history
    labels_flat: Optional[np.ndarray]  # [total_imp_slots] int8, None if no labels
    label_present: bool

    @property
    def num_rows(self) -> int:
        return len(self.imp_lens)

    @property
    def num_news(self) -> int:
        return len(self.news_ids)

    @property
    def has_history(self) -> np.ndarray:
        """Boolean mask over all rows: does this row have click history?"""
        mask = np.zeros(self.num_rows, dtype=bool)
        mask[self.hist_row_index] = True
        return mask

    def with_history_view(self) -> "CompiledBehaviors":
        """Restrict to the rows that have click history, renumbering rows to
        the subset: the row space the tower trainers and evals work in."""
        keep = self.hist_row_index
        slot_mask = np.repeat(self.has_history, self.imp_lens)
        return CompiledBehaviors(
            news_ids=self.news_ids,
            imp_rev=self.imp_rev[slot_mask],
            imp_row=np.repeat(np.arange(len(keep), dtype=np.int32), self.imp_lens[keep]),
            imp_lens=self.imp_lens[keep],
            hist_rev=self.hist_rev,
            hist_row=self.hist_row,
            hist_lens=self.hist_lens,
            hist_row_index=np.arange(len(keep), dtype=np.int32),
            labels_flat=self.labels_flat[slot_mask] if self.labels_flat is not None else None,
            label_present=self.label_present,
        )


def _is_missing(value) -> bool:
    if value is None:
        return True
    if isinstance(value, float) and np.isnan(value):
        return True
    return isinstance(value, str) and value.strip() == ""


def _factorize(tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, uniques) with uniques in first-appearance order, as
    ``pandas.factorize`` gives them."""
    uniques, first, inverse = np.unique(tokens, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank[inverse.reshape(-1)], uniques[order]


def _from_native(result) -> CompiledBehaviors:
    news, imp_rev, imp_row, imp_lens, hist_rev, hist_row, hist_lens, hist_row_index, labels, label_present = result

    def i32(b: bytes) -> np.ndarray:
        return np.frombuffer(b, dtype=np.int32).copy()  # writable, as the numpy path's

    return CompiledBehaviors(
        news_ids=np.asarray(news, dtype=np.str_),
        imp_rev=i32(imp_rev),
        imp_row=i32(imp_row),
        imp_lens=i32(imp_lens),
        hist_rev=i32(hist_rev),
        hist_row=i32(hist_row),
        hist_lens=i32(hist_lens),
        hist_row_index=i32(hist_row_index),
        labels_flat=None if labels is None else np.frombuffer(labels, dtype=np.int8).copy(),
        label_present=bool(label_present),
    )


def compile_native(impressions: Sequence[str], history: Sequence[Optional[str]]) -> CompiledBehaviors:
    """``compile_behaviors`` through the C++ extension alone, for a caller
    that must know it ran: raises ``RuntimeError`` where ``native.load``
    gives none and ``TypeError`` for inputs it does not read (anything but
    ``str``, and ``None`` or NaN in ``history``), where ``compile_behaviors``
    would take the numpy path."""
    from .. import native

    module = native.load()
    if module is None:
        raise RuntimeError("the native behaviors compiler could not be built")
    return _from_native(module.compile_behaviors(list(impressions), list(history)))


def compile_behaviors(
    impressions: Sequence[str], history: Sequence[Optional[str]], use_native: bool = True
) -> CompiledBehaviors:
    """Compile behavior strings into flat index arrays.

    ``impressions[i]`` is a space-separated list of ``NewsID`` or
    ``NewsID-{0,1}`` tokens; ``history[i]`` is a space-separated ``NewsID``
    list or missing. A labeled token that does not end in ``-0`` or ``-1``
    raises ``ValueError`` on both paths. ``use_native`` takes the C++
    extension where ``native.load`` gives one, else (or for inputs of other
    types than it reads) the numpy path.
    """
    n = len(impressions)
    if n == 0:
        raise ValueError("No impressions given")
    if len(history) != n:
        raise ValueError("history and impressions must have equal row counts")
    if use_native:
        from .. import native

        if native.load() is not None:
            try:
                return compile_native(impressions, history)
            except TypeError:
                # Inputs of other types (numpy strings, ...): the numpy path
                # reads them or raises. A ValueError (a malformed label)
                # propagates, as the numpy path raises it too.
                pass
    label_present = "-" in impressions[0]

    hist_tokens, hist_row_index = [], []
    for i, h in enumerate(history):
        if not _is_missing(h):
            hist_tokens.append(h.split())
            hist_row_index.append(i)
    imp_tokens = [row.split() for row in impressions]
    hist_lens = np.array([len(t) for t in hist_tokens], dtype=np.int32)
    imp_lens = np.array([len(t) for t in imp_tokens], dtype=np.int32)
    hist_row_index = np.array(hist_row_index, dtype=np.int32)

    imp_flat = np.array([tok for row in imp_tokens for tok in row], dtype=np.str_)
    labels_flat: Optional[np.ndarray] = None
    if label_present:
        # "N1234-1" -> ("N1234", "-", "1"); rpartition handles ids with "-".
        parts = np.char.rpartition(imp_flat, "-")
        bad = (parts[:, 1] != "-") | ~np.isin(parts[:, 2], ("0", "1"))
        if bad.any():
            flat_row = np.repeat(np.arange(n), imp_lens)
            raise ValueError(
                f"malformed labeled token in row {int(flat_row[np.flatnonzero(bad)[0]])}"
            )
        imp_flat = parts[:, 0]
        labels_flat = parts[:, 2].astype(np.int8)
    hist_flat = np.array([tok for row in hist_tokens for tok in row], dtype=np.str_)

    # First appearance runs row by row, history tokens before impression
    # tokens: order the joint stream by (row, history first), stably.
    key = np.concatenate(
        [
            2 * np.repeat(hist_row_index.astype(np.int64), hist_lens),
            2 * np.repeat(np.arange(n, dtype=np.int64), imp_lens) + 1,
        ]
    )
    order = np.argsort(key, kind="stable")
    stream = np.concatenate([hist_flat, imp_flat]).astype(np.str_)[order]
    codes_sorted, news_ids = _factorize(stream)
    codes = np.empty(len(order), dtype=np.int32)
    codes[order] = codes_sorted
    return CompiledBehaviors(
        news_ids=news_ids,
        imp_rev=codes[len(hist_flat) :],
        imp_row=np.repeat(np.arange(n, dtype=np.int32), imp_lens),
        imp_lens=imp_lens,
        hist_rev=codes[: len(hist_flat)],
        hist_row=np.repeat(np.arange(len(hist_lens), dtype=np.int32), hist_lens),
        hist_lens=hist_lens,
        hist_row_index=hist_row_index,
        labels_flat=labels_flat,
        label_present=label_present,
    )
