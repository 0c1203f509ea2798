"""Synthetic fixtures: random unit-norm news embeddings and behavior strings
whose clicks a history tower can learn (the port's copy of the JAX package's
``data/synthetic.py`` helpers for training, drawing the same numbers from
the same seed)."""

from __future__ import annotations

import numpy as np


def synthetic_news_embeddings(
    num_news: int, dim: int, seed: int = 0
) -> np.ndarray:
    """Unit-norm random news embeddings standing in for frozen encoder output."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((num_news, dim)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def align_embeddings(news_ids: np.ndarray, emb: np.ndarray) -> np.ndarray:
    """Reorder an ``N{row}``-keyed embedding matrix to a compiled ``news_ids``
    order (compile_behaviors assigns indices by first appearance)."""
    rows = np.array([int(str(n)[1:]) for n in news_ids])
    return emb[rows]


def synthetic_learnable_behaviors(
    num_news: int = 200,
    num_rows: int = 300,
    dim: int = 64,
    max_history: int = 20,
    max_impressions: int = 12,
    noise: float = 0.1,
    seed: int = 1234,
):
    """Behavior strings whose click labels correlate with
    cosine(mean history embedding, candidate embedding) — a signal a history
    tower can actually learn. Returns (impressions, history, embeddings)."""
    rng = np.random.default_rng(seed)
    emb = synthetic_news_embeddings(num_news, dim, seed=seed)
    impressions, history = [], []
    for i in range(num_rows):
        hk = int(rng.integers(2, max_history))
        hist_ids = rng.choice(num_news, size=hk, replace=False)
        user = emb[hist_ids].mean(0)
        user /= np.linalg.norm(user)
        k = int(rng.integers(4, max_impressions))
        cand_ids = rng.choice(num_news, size=k, replace=False)
        scores = emb[cand_ids] @ user + rng.standard_normal(k) * noise
        median = np.median(scores)
        labs = (scores > median).astype(int)
        if labs.sum() == 0:
            labs[np.argmax(scores)] = 1
        if labs.sum() == k:
            labs[np.argmin(scores)] = 0
        impressions.append(
            " ".join(f"N{c}-{l}" for c, l in zip(cand_ids, labs))
        )
        history.append(" ".join(f"N{j}" for j in hist_ids))
    return impressions, history, emb
