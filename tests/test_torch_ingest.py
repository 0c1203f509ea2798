"""The port's ingest (no pandas, no pyarrow) against the JAX package's
pandas reader: the synthetic raw writer byte for byte, then
``store_processed_data`` + ``load_dataset`` on the synthetic fixture and
on a hand-written one with quoted titles, missing abstracts and titles, a
pandas NA word, rows with no history and entities the vector file lacks.
Equal means: the behaviors columns, the news ids, texts, titles,
abstracts and category ids, the vocabulary files byte for byte, and the
entity means exactly (both take the mean of the same float32 rows)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from news_recommendation_project_v2_tpu.config import DataSubset as JaxSubset
from news_recommendation_project_v2_tpu.config import NewsDataset as JaxDataset
from news_recommendation_project_v2_tpu.data import ingest as jax_ingest
from news_recommendation_project_v2_tpu.data.synthetic import write_synthetic_mind as jax_write_synthetic_mind
from news_recommendation_project_v2_torch.config import DataSubset, NewsDataset
from news_recommendation_project_v2_torch.data import ingest
from news_recommendation_project_v2_torch.data.synthetic import write_synthetic_mind
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SPLITS = ("MINDsmall_train", "MINDsmall_dev")
FILES = ("news.tsv", "behaviors.tsv", "entity_embedding.vec")


@pytest.mark.parametrize("name", SPLITS)
def test_synthetic_writer_writes_the_same_bytes(tmp_path, name):
    a = write_synthetic_mind(tmp_path / "port", NewsDataset[name])
    b = jax_write_synthetic_mind(tmp_path / "jax", JaxDataset[name])
    for f in FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _hand_written(root):
    """A raw split with the fields the pandas reader treats specially."""
    raw = root / "raw" / "MINDsmall_dev"
    raw.mkdir(parents=True)
    ents = lambda *ids: json.dumps([{"WikidataId": i, "Label": "x"} for i in ids])  # noqa: E731
    news = [
        ["N1", "news", "newsus", '"Survivor" winner says "hi"', "An abstract.", "u1", ents("Q1", "Q2"), ents("Q9")],
        ["N2", "sports", "golf", 'He said "yes" twice', "", "u2", "[]", ""],
        ["N3", "news", "newsworld", "", "NA", "u3", ents("Q404"), ents("Q2", "Q404")],
        ["N4", "finance", "markets", "Café prices – up 5%", '"Quoted" abstract "here"', "u4", "", ents("Q1")],
        ["N5", "sports", "golf", "null", "Body.", "u5", ents("Q2"), "[]"],
    ]
    (raw / "news.tsv").write_text("".join("\t".join(r) + "\n" for r in news), encoding="utf-8")
    rng = np.random.default_rng(0)
    vec = "".join(
        f"Q{i}\t" + "\t".join(f"{v:.6f}" for v in rng.standard_normal(100)) + "\t\n" for i in (1, 2, 9)
    )
    (raw / "entity_embedding.vec").write_text(vec)
    behaviors = [
        ["1", "U1", "11/11/2019 9:05:58 AM", "N1 N2", "N3-1 N4-0"],
        ["2", "U2", "11/12/2019 9:05:58 AM", "", "N1-0 N5-1"],
        ["3", "U3", "11/13/2019 9:05:58 AM", "N4", "N2-1 N3-0 N1-0"],
        ["4", "U4", "11/14/2019 9:05:58 AM", "", "N2-0 N4-1"],
        ["5", "U1", "11/15/2019 9:05:58 AM", "N5 N3 N1", "N4-1 N2-0"],
    ]
    (raw / "behaviors.tsv").write_text("".join("\t".join(r) + "\n" for r in behaviors) + "\n")
    return "MINDsmall_dev"


def _raw_fixture(root, kind):
    if kind == "synthetic":
        for name in SPLITS:
            write_synthetic_mind(root, NewsDataset[name])
        return SPLITS
    return (_hand_written(root),)


def _history(values):
    return [v if isinstance(v, str) else None for v in values]


def _assert_same_dataset(got, want):
    b = got.behaviors
    assert b.impression_id.dtype == np.int64
    assert b.impression_id.tolist() == want.behaviors["ImpressionID"].tolist()
    assert b.history.tolist() == _history(want.behaviors["History"].tolist())
    assert b.impressions.tolist() == want.behaviors["Impressions"].tolist()
    assert [b["History"], b["Impressions"]] == [b.history, b.impressions]
    assert got.news_ids.tolist() == want.news_ids.tolist()
    for key in ("news_text", "news_title", "news_abstract", "news_category", "news_subcategory"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("news_title_entity", "news_abstract_entity"):
        g, w = getattr(got, key), getattr(want, key)
        assert g.keys() == w.keys()
        for n in g:
            assert g[n].dtype == np.float32
            np.testing.assert_array_equal(g[n], w[n])


@pytest.fixture(scope="module", params=["synthetic", "hand_written"])
def stores(request, tmp_path_factory):
    """The raw fixture ingested by both packages into separate roots."""
    root = tmp_path_factory.mktemp(request.param)
    names = _raw_fixture(root / "port", request.param)
    _raw_fixture(root / "jax", request.param)
    for name in names:
        out = ingest.store_processed_data(root / "port", NewsDataset[name])
        jax_ingest.store_processed_data(root / "jax", JaxDataset[name])
        assert sorted(p.name for p in out.iterdir()) == ["behaviors.npz", "entity_embeds.npz", "news.npz"]
    return root, names


def test_vocabularies_and_entity_tables_match(stores):
    root, names = stores
    for f in ("categories.json", "sub_categories.json"):
        assert (root / "port" / f).read_bytes() == (root / "jax" / f).read_bytes()
    for name in names:
        got = np.load(root / "port" / "processed" / name / "entity_embeds.npz")
        want = np.load(root / "jax" / "processed" / name / "entity_embeds.npz")
        np.testing.assert_array_equal(got["entity_ids"], want["entity_ids"])
        assert got["entity_vecs"].dtype == np.float32
        np.testing.assert_array_equal(got["entity_vecs"], want["entity_vecs"])


@pytest.mark.parametrize("subset", [s.name for s in DataSubset])
def test_load_dataset_matches_the_pandas_loader(stores, subset):
    root, names = stores
    for name in names:
        got = ingest.load_dataset(root / "port", NewsDataset[name], data_subset=DataSubset[subset])
        want = jax_ingest.load_dataset(root / "jax", JaxDataset[name], data_subset=JaxSubset[subset])
        _assert_same_dataset(got, want)
        has_history = [h is not None for h in got.behaviors.history]
        assert all(has_history) if subset == "WITH_HISTORY" else True
        assert not any(has_history) if subset == "WITHOUT_HISTORY" else True


@pytest.mark.parametrize("num_samples,seed", [(7, 1234), (3, 5), (1000, 1234)])
def test_num_samples_draws_the_rows_pandas_draws(stores, num_samples, seed):
    """``DataFrame.sample(n, random_state=seed)``: the same rows in the same
    order, after the subset filter; all rows when n is not fewer."""
    root, names = stores
    for subset in ("ALL", "WITH_HISTORY"):
        got = ingest.load_dataset(
            root / "port", NewsDataset[names[0]], num_samples=num_samples, data_subset=DataSubset[subset], seed=seed
        )
        want = jax_ingest.load_dataset(
            root / "jax", JaxDataset[names[0]], num_samples=num_samples, data_subset=JaxSubset[subset], seed=seed
        )
        _assert_same_dataset(got, want)


def test_hand_written_fields_read_as_pandas_reads_them(tmp_path):
    """The cases themselves: a leading quote is dropped with its closing
    one and the text after it kept, later quotes stay, ``NA``/``null`` and empty fields are missing,
    entities without a vector are skipped, a news with none gets zeros."""
    _hand_written(tmp_path)
    ingest.store_processed_data(tmp_path, NewsDataset.MINDsmall_dev)
    ds = ingest.load_dataset(tmp_path, NewsDataset.MINDsmall_dev)
    assert ds.news_title["N1"] == 'News Title: Survivor winner says "hi"'
    assert ds.news_title["N2"] == 'News Title: He said "yes" twice'
    assert "N3" not in ds.news_title and "N5" not in ds.news_title
    assert ds.news_text["N3"] == ds.news_text["N5"] == "Title: "
    assert "N2" not in ds.news_abstract and "N3" not in ds.news_abstract
    assert ds.news_abstract["N4"] == 'News Abstract: Quoted abstract "here"'
    assert ds.behaviors.history.tolist() == ["N1 N2", None, "N4", None, "N5 N3 N1"]
    np.testing.assert_array_equal(ds.news_title_entity["N4"], np.zeros(100, np.float32))
    assert np.abs(ds.news_title_entity["N3"]).sum() == 0  # Q404 has no vector
    assert ds.news_category == {"N1": 0, "N2": 1, "N3": 0, "N4": 2, "N5": 1}


def test_ingest_and_load_need_no_pandas_or_pyarrow(tmp_path):
    """The port's ingest CLI and loader in a process where importing pandas
    or pyarrow fails."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "from news_recommendation_project_v2_torch.cli import ingest\n"
        "from news_recommendation_project_v2_torch.config import NewsDataset\n"
        "from news_recommendation_project_v2_torch.data.ingest import load_dataset\n"
        f"ingest.main([{str(tmp_path)!r}, 'MINDsmall_dev', '--synthetic'])\n"
        f"ds = load_dataset({str(tmp_path)!r}, NewsDataset.MINDsmall_dev)\n"
        "assert len(ds.behaviors) == 40 and len(ds.news_ids) == 60\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
