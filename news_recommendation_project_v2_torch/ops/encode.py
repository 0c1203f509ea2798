"""The id-keyed embedding dump as ``.npy`` files: ``{dataset}.npy`` [N, D],
optional ``query_{dataset}.npy`` [N, D] and ``{dataset}_ids.npy`` [N] (the
row -> news-id key). The same files the JAX package's ``save_emb`` writes."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


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
