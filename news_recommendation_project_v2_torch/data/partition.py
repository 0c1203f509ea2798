"""Per-host input partitioning: deterministic, disjoint row shards of a
compiled behaviors set, with the news-id space left global (the table's rows
are sharded over the mesh's ``model`` axis, not per host)."""

from __future__ import annotations

import numpy as np

from .compiler import CompiledBehaviors
from .grouping import lengths_to_offsets


def shard_rows(compiled: CompiledBehaviors, host_id: int, num_hosts: int, seed: int = 0) -> CompiledBehaviors:
    """Host ``host_id``'s row shard: the rows permuted with ``seed`` (the
    same on every host) and dealt round-robin, so the shards are disjoint,
    cover every row and differ in size by at most one. News ids and the
    ``*_rev`` indices stay in the global space."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(compiled.num_rows)
    keep_rows = np.sort(perm[host_id::num_hosts])

    keep_mask = np.zeros(compiled.num_rows, dtype=bool)
    keep_mask[keep_rows] = True
    slot_mask = np.repeat(keep_mask, compiled.imp_lens)

    # The history arrays live in the with-history subset's row space.
    hist_keep_mask = keep_mask[compiled.hist_row_index]
    hist_keep = np.flatnonzero(hist_keep_mask)
    offsets = lengths_to_offsets(compiled.hist_lens)
    parts = [np.arange(offsets[i], offsets[i + 1]) for i in hist_keep]
    hist_slots = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)

    new_hist_lens = compiled.hist_lens[hist_keep]
    return CompiledBehaviors(
        news_ids=compiled.news_ids,
        imp_rev=compiled.imp_rev[slot_mask],
        imp_row=np.repeat(np.arange(len(keep_rows), dtype=np.int32), compiled.imp_lens[keep_rows]),
        imp_lens=compiled.imp_lens[keep_rows],
        hist_rev=compiled.hist_rev[hist_slots],
        hist_row=np.repeat(np.arange(len(new_hist_lens), dtype=np.int32), new_hist_lens),
        hist_lens=new_hist_lens,
        hist_row_index=np.searchsorted(keep_rows, compiled.hist_row_index[hist_keep_mask]).astype(np.int32),
        labels_flat=compiled.labels_flat[slot_mask] if compiled.labels_flat is not None else None,
        label_present=compiled.label_present,
    )
