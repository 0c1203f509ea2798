"""MIND's raw TSVs -> the port's processed store, and its loader, without
pandas or pyarrow.

The raw files are read as the JAX package's pandas reader reads them
(``read_csv(sep="\\t", header=None)``): ``"`` quotes a field that starts
with it (``""`` inside is one quote; the quote marks are dropped), an empty
field or one of pandas' NA words (``NA``, ``null``, ``nan``, ...) is
missing, blank lines are skipped, and ``entity_embedding.vec``'s first and
last columns (the id and the empty field after the trailing tab) are not
floats. The values equal the JAX package's ``load_dataset`` on the same raw
files.

The processed store, under ``DATA_DIR/processed/<dataset>/``:

- ``behaviors.npz`` and ``news.npz``: one table each. A text column ``C`` is
  three arrays: ``C|bytes`` (the UTF-8 values back to back, uint8),
  ``C|offsets`` (int64, value ``i`` is ``bytes[offsets[i]:offsets[i + 1]]``)
  and ``C|present`` (bool, False where the value is missing). Behaviors hold
  ``ImpressionID`` (int64) and the text columns ``UserID``, ``Time``,
  ``History`` and ``Impressions``; news hold the eight columns of
  ``news.tsv`` and ``news_text``.
- ``entity_embeds.npz``: ``entity_ids`` (str) and ``entity_vecs`` [E, 100]
  float32, as the JAX package writes it.

and the vocabularies ``DATA_DIR/categories.json`` and
``sub_categories.json``, shared by the splits and extended by each ingest,
byte for byte the JAX package's.
"""

from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import ENTITY_EMBEDDING_DIM, DataSubset, NewsDataset

BEHAVIOR_COLUMNS = ["ImpressionID", "UserID", "Time", "History", "Impressions"]
NEWS_COLUMNS = [
    "NewsID",
    "Category",
    "SubCategory",
    "Title",
    "Abstract",
    "URL",
    "Title Entities",
    "Abstract Entities",
]

# The words pandas' ``read_csv`` reads as missing by default.
NA_VALUES = frozenset(
    {
        "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
        "nan", "null",
    }
)

Text = Optional[str]  # a text value; None where it is missing


def _read_tsv(path: Path) -> list[list[str]]:
    """The rows of a tab-separated file under pandas' quoting rules; blank
    lines skipped."""
    with open(path, newline="", encoding="utf-8") as f:
        return [row for row in csv.reader(f, delimiter="\t", quotechar='"', doublequote=True, strict=False) if row]


def _column(rows: list[list[str]], i: int) -> list[Text]:
    """Column ``i`` with missing values as None (a short row's tail is
    missing)."""
    return [None if len(r) <= i or r[i] in NA_VALUES else r[i] for r in rows]


def read_raw(data_dir: Path, dataset: NewsDataset):
    """``(behaviors, news, entity_ids, entity_vecs)`` from
    ``DATA_DIR/raw/<dataset>/``: behaviors and news as dicts of columns
    (``ImpressionID`` an int64 array, the others lists of text values),
    the entity ids as a str array and their vectors [E, 100] float32."""
    raw = Path(data_dir) / "raw" / dataset.value
    rows = _read_tsv(raw / "behaviors.tsv")
    behaviors: dict = {name: _column(rows, i) for i, name in enumerate(BEHAVIOR_COLUMNS)}
    behaviors["ImpressionID"] = np.array([int(v) for v in behaviors["ImpressionID"]], dtype=np.int64)
    rows = _read_tsv(raw / "news.tsv")
    news = {name: _column(rows, i) for i, name in enumerate(NEWS_COLUMNS)}
    rows = _read_tsv(raw / "entity_embedding.vec")
    entity_ids = np.array([r[0] for r in rows], dtype=np.str_)
    width = max((len(r) for r in rows), default=2)
    entity_vecs = np.array(
        [[float(v) if v not in NA_VALUES else np.nan for v in r[1 : width - 1]] for r in rows], dtype=np.float64
    ).reshape(len(rows), width - 2).astype(np.float32)
    assert entity_vecs.shape[1] == ENTITY_EMBEDDING_DIM, entity_vecs.shape
    return behaviors, news, entity_ids, entity_vecs


def build_news_text(news: dict) -> dict:
    """The news table with ``news_text``: the title-only template
    ``"Title: " + title`` (an empty title where it is missing)."""
    return {**news, "news_text": ["Title: " + (t or "") for t in news["Title"]]}


def _pack(values: Sequence[Text], name: str) -> dict[str, np.ndarray]:
    encoded = [b"" if v is None else v.encode("utf-8") for v in values]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    return {
        f"{name}|bytes": np.frombuffer(b"".join(encoded), dtype=np.uint8),
        f"{name}|offsets": offsets,
        f"{name}|present": np.array([v is not None for v in values], dtype=bool),
    }


def _unpack(table, name: str) -> list[Text]:
    buf = table[f"{name}|bytes"].tobytes()
    offsets = table[f"{name}|offsets"].tolist()
    present = table[f"{name}|present"].tolist()
    return [buf[a:b].decode("utf-8") if p else None for a, b, p in zip(offsets[:-1], offsets[1:], present)]


def store_processed_data(data_dir: Path, dataset: NewsDataset) -> Path:
    """Write the processed store of ``dataset`` (module docstring) and
    extend the category vocabularies; returns the dataset's directory."""
    data_dir = Path(data_dir)
    behaviors, news, entity_ids, entity_vecs = read_raw(data_dir, dataset)
    news = build_news_text(news)

    out = data_dir / "processed" / dataset.value
    out.mkdir(parents=True, exist_ok=True)
    packed = {"ImpressionID": behaviors["ImpressionID"]}
    for name in BEHAVIOR_COLUMNS[1:]:
        packed.update(_pack(behaviors[name], name))
    np.savez(out / "behaviors.npz", **packed)
    packed = {}
    for name in [*NEWS_COLUMNS, "news_text"]:
        packed.update(_pack(news[name], name))
    np.savez(out / "news.npz", **packed)
    np.savez(out / "entity_embeds.npz", entity_ids=entity_ids, entity_vecs=entity_vecs)

    for column, fname in (("Category", "categories.json"), ("SubCategory", "sub_categories.json")):
        vocab_path = data_dir / fname
        existing = json.loads(vocab_path.read_text()) if vocab_path.exists() else {}
        nxt = max(existing.values(), default=-1) + 1
        for name in dict.fromkeys(v for v in news[column] if v is not None):
            if name not in existing:
                existing[name] = nxt
                nxt += 1
        vocab_path.write_text(json.dumps(existing, indent=1))
    return out


@dataclasses.dataclass
class Behaviors:
    """The behaviors rows a load keeps, as numpy columns: ``impression_id``
    int64, ``history`` and ``impressions`` object arrays of str, ``history``
    None where the row has no history. ``behaviors["History"]`` names a
    column as the raw file does."""

    impression_id: np.ndarray
    history: np.ndarray
    impressions: np.ndarray

    COLUMNS = {"ImpressionID": "impression_id", "History": "history", "Impressions": "impressions"}

    def __len__(self) -> int:
        return len(self.impression_id)

    def __getitem__(self, column: str) -> np.ndarray:
        return getattr(self, self.COLUMNS[column])

    def take(self, rows: np.ndarray) -> "Behaviors":
        return Behaviors(self.impression_id[rows], self.history[rows], self.impressions[rows])


def _objects(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


@dataclasses.dataclass
class LoadedDataset:
    """The behaviors and the per-news features, keyed by news id.
    ``news_ids`` holds the news table's ids in its order."""

    behaviors: Behaviors
    news_ids: np.ndarray  # [n_news] str
    news_text: dict[str, str]
    news_title: dict[str, str]
    news_abstract: dict[str, str]
    news_category: dict[str, Optional[int]]
    news_subcategory: dict[str, Optional[int]]
    news_title_entity: dict[str, np.ndarray]  # the mean 100-dim entity vector
    news_abstract_entity: dict[str, np.ndarray]


def _mean_entity_vectors(
    news_ids: list[str], payloads: list[Text], id_to_row: dict[str, int], vecs: np.ndarray
) -> dict[str, np.ndarray]:
    """Each news' mean vector of its entities that have one (JSON list of
    ``{"WikidataId": ...}``); zeros where it has none."""
    out: dict[str, np.ndarray] = {}
    zero = np.zeros(ENTITY_EMBEDDING_DIM, dtype=np.float32)
    for news_id, payload in zip(news_ids, payloads):
        if payload is None:
            out[news_id] = zero
            continue
        rows = [id_to_row[e["WikidataId"]] for e in json.loads(payload) if e.get("WikidataId") in id_to_row]
        out[news_id] = vecs[rows].mean(axis=0) if rows else zero
    return out


def load_dataset(
    data_dir: Path,
    dataset: NewsDataset,
    num_samples: Optional[int] = None,
    data_subset: DataSubset = DataSubset.ALL,
    seed: int = 1234,
) -> LoadedDataset:
    """The processed store of ``dataset``: the rows of ``data_subset``, then,
    where ``num_samples`` is fewer than them, ``num_samples`` rows drawn
    without replacement, in the order pandas' ``DataFrame.sample(n,
    random_state=seed)`` draws them (``RandomState(seed).permutation``'s
    first ``n``); the per-news features as dicts keyed by news id."""
    data_dir = Path(data_dir)
    proc = data_dir / "processed" / dataset.value
    with np.load(proc / "behaviors.npz", allow_pickle=False) as table:
        behaviors = Behaviors(
            table["ImpressionID"], _objects(_unpack(table, "History")), _objects(_unpack(table, "Impressions"))
        )
    with np.load(proc / "news.npz", allow_pickle=False) as table:
        news = {name: _unpack(table, name) for name in [*NEWS_COLUMNS, "news_text"]}
    ent = np.load(proc / "entity_embeds.npz", allow_pickle=False)
    id_to_row = {str(e): i for i, e in enumerate(ent["entity_ids"])}
    cat_vocab = json.loads((data_dir / "categories.json").read_text())
    subcat_vocab = json.loads((data_dir / "sub_categories.json").read_text())

    has_history = np.array([h is not None for h in behaviors.history], dtype=bool)
    if data_subset == DataSubset.WITH_HISTORY:
        behaviors = behaviors.take(np.flatnonzero(has_history))
    elif data_subset == DataSubset.WITHOUT_HISTORY:
        behaviors = behaviors.take(np.flatnonzero(~has_history))
    if num_samples and num_samples < len(behaviors):
        behaviors = behaviors.take(np.random.RandomState(seed).permutation(len(behaviors))[:num_samples])

    ids = news["NewsID"]

    def by_id(values, prefix: str = "") -> dict:
        return {k: prefix + v for k, v in zip(ids, values) if v is not None}

    return LoadedDataset(
        behaviors=behaviors,
        news_ids=np.array(ids, dtype=np.str_),
        news_text=dict(zip(ids, news["news_text"])),
        news_title=by_id(news["Title"], "News Title: "),
        news_abstract=by_id(news["Abstract"], "News Abstract: "),
        news_category={k: cat_vocab.get(v) for k, v in zip(ids, news["Category"])},
        news_subcategory={k: subcat_vocab.get(v) for k, v in zip(ids, news["SubCategory"])},
        news_title_entity=_mean_entity_vectors(ids, news["Title Entities"], id_to_row, ent["entity_vecs"]),
        news_abstract_entity=_mean_entity_vectors(ids, news["Abstract Entities"], id_to_row, ent["entity_vecs"]),
    )
