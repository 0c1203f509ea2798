"""Synthetic fixtures: a miniature MIND dataset in the raw files' layout,
random unit-norm news embeddings, and behavior strings whose clicks a
history tower can learn (the port's copy of the JAX package's
``data/synthetic.py``, drawing the same numbers from the same seed and
writing the same bytes)."""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from ..config import ENTITY_EMBEDDING_DIM, NewsDataset

CATEGORIES = ["news", "sports", "finance", "lifestyle"]
SUBCATEGORIES = ["us", "soccer", "markets", "travel", "weather", "golf"]


def write_synthetic_mind(
    root: Path,
    dataset: NewsDataset = NewsDataset.MINDsmall_train,
    num_news: int = 60,
    num_rows: int = 40,
    max_history: int = 12,
    max_impressions: int = 10,
    seed: int = 1234,
) -> Path:
    """Write behaviors.tsv, news.tsv and entity_embedding.vec under
    ``root/raw/<dataset>/`` and return that directory. The seed is offset by
    the dataset's name, so the train and dev splits differ. Every fifth
    article has no abstract, every third no entities, every fifth row no
    history."""
    rng = np.random.default_rng(seed + zlib.crc32(dataset.value.encode()) % 1000)
    raw = Path(root) / "raw" / dataset.value
    raw.mkdir(parents=True, exist_ok=True)

    news_ids = np.array([f"N{i}" for i in range(num_news)])
    entity_ids = [f"Q{i}" for i in range(num_news // 2)]

    with open(raw / "news.tsv", "w") as f:
        for i, nid in enumerate(news_ids.tolist()):
            cat = CATEGORIES[i % len(CATEGORIES)]
            subcat = SUBCATEGORIES[i % len(SUBCATEGORIES)]
            title = f"Synthetic headline number {i} about {cat}"
            abstract = f"Synthetic abstract body for article {i}." if i % 5 else ""
            ents = json.dumps([{"WikidataId": entity_ids[i % len(entity_ids)]}]) if i % 3 else ""
            f.write("\t".join([nid, cat, subcat, title, abstract, f"https://example.com/{nid}", ents, ents]) + "\n")

    with open(raw / "entity_embedding.vec", "w") as f:
        for eid in entity_ids:
            vec = rng.standard_normal(ENTITY_EMBEDDING_DIM)
            f.write(eid + "\t" + "\t".join(f"{v:.6f}" for v in vec) + "\t\n")

    with open(raw / "behaviors.tsv", "w") as f:
        for i in range(num_rows):
            uid = f"U{i % (num_rows // 2)}"
            time = f"11/1{i % 5}/2019 {i % 12}:3{i % 6}:00 AM"
            if i % 5 == 4:
                history = ""
            else:
                k = int(rng.integers(1, max_history))
                history = " ".join(rng.choice(news_ids, size=k, replace=False).tolist())
            k = int(rng.integers(2, max_impressions))
            cands = rng.choice(news_ids, size=k, replace=False)
            labels = rng.integers(0, 2, size=k)
            labels[0] = 1
            if labels.sum() == k:
                labels[-1] = 0
            imps = " ".join(f"{c}-{l}" for c, l in zip(cands.tolist(), labels.tolist()))
            f.write("\t".join([str(i + 1), uid, time, history, imps]) + "\n")

    return raw


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
