"""The port's public names, host partitioning and native behaviors compiler
against the JAX package: each subpackage's ``__all__`` holds every JAX name;
``expand_items``, ``rank_group_preds``, ``shard_rows`` and
``partition_rows_by_tokens`` give the JAX arrays; the native compiler
(``native/behaviors_compiler.cpp``, built into ``build/native/``) gives the
numpy path's and the JAX package's arrays over the cases of
``tests/test_native_compiler.py``, builds once when two processes reach it
together, and falls back to numpy, with a warning, where it cannot build."""

import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from news_recommendation_project_v2_torch import native
from news_recommendation_project_v2_torch.data import compiler as port_compiler
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors, compile_native
from news_recommendation_project_v2_torch.data.grouping import expand_items, rank_group_preds
from news_recommendation_project_v2_torch.data.partition import shard_rows
from news_recommendation_project_v2_torch.parallel.flat_eval import partition_rows_by_tokens
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.data.grouping import expand_items as jax_expand_items
from news_recommendation_project_v2_tpu.data.grouping import rank_group_preds as jax_rank_group_preds
from news_recommendation_project_v2_tpu.data.partition import shard_rows as jax_shard_rows
from news_recommendation_project_v2_tpu.parallel.flat_eval import partition_rows_by_tokens as jax_partition
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

FIELDS = ("imp_rev", "imp_row", "imp_lens", "hist_rev", "hist_row", "hist_lens", "hist_row_index", "labels_flat")
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("sub", [".data", ".eval", ".ops", ".utils", ".parallel", ".train", ".pipeline", ".models"])
def test_all_holds_every_jax_name(sub):
    jax_names = set(importlib.import_module(f"news_recommendation_project_v2_tpu{sub}").__all__)
    port = importlib.import_module(f"news_recommendation_project_v2_torch{sub}")
    assert jax_names <= set(port.__all__), sorted(jax_names - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_grouping_helpers_match_jax():
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 9, size=30)
    scores = np.round(rng.random(int(counts.sum())), 1)  # ties within impressions
    items = rng.standard_normal(50)
    rev = rng.integers(0, 50, size=int(counts.sum()))
    np.testing.assert_array_equal(expand_items(items, rev, counts), jax_expand_items(items, rev, counts))
    got, want = rank_group_preds(scores, counts), jax_rank_group_preds(scores, counts)
    assert got.dtype == want.dtype == object and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        expand_items(items, rev, counts + 1)


def _behaviors(rng, rows=500, n_news=300):
    """``tests/test_native_compiler.py``'s random rows: labeled impressions,
    histories present, None, NaN or empty."""
    impressions, history = [], []
    for _ in range(rows):
        k = int(rng.integers(2, 15))
        ids, labs = rng.choice(n_news, size=k, replace=False), rng.integers(0, 2, size=k)
        impressions.append(" ".join(f"N{j}-{lab}" for j, lab in zip(ids, labs)))
        r = rng.random()
        if r < 0.7:
            hk = int(rng.integers(1, 30))
            history.append(" ".join(f"N{j}" for j in rng.choice(n_news, size=min(hk, n_news), replace=False)))
        else:
            history.append(None if r < 0.8 else float("nan") if r < 0.9 else "")
    return impressions, history


CASES = {
    "random": _behaviors(np.random.default_rng(1234)),
    "unlabeled": (["N1 N2", "N3 N1"], ["N9", None]),
    "hyphenated_ids": (["X-1-0 X-2-1"], [None]),
    "extra_whitespace": (["N1-1  N2-0"], ["  N3   N4 "]),
    "tab_newline": (["N1-1\tN2-0 N3-1", "N4-0\nN5-1"], ["N6\tN7\nN8", "  \t  "]),
}


def _assert_same(a, b):
    assert a.news_ids.tolist() == b.news_ids.tolist()
    for field in FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=field)
            assert x.dtype == y.dtype, field
    assert a.label_present == b.label_present


@pytest.mark.parametrize("case", list(CASES))
def test_native_compiler_matches_numpy_and_jax(case):
    impressions, history = CASES[case]
    assert native.load() is not None, "g++ builds the extension here"
    got = compile_native(impressions, history)  # raises rather than fall back to numpy
    _assert_same(got, compile_behaviors(impressions, history, use_native=True))
    _assert_same(got, compile_behaviors(impressions, history, use_native=False))
    _assert_same(got, jax_compile(impressions, history, use_native=False))
    assert got.imp_rev.flags.writeable


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_compiler_refusals_match_on_both_paths(use_native):
    with pytest.raises(ValueError, match="malformed labeled token in row 1"):
        compile_behaviors(["N1-1 N2-0", "N3-7 N4-1"], [None, None], use_native=use_native)
    with pytest.raises((TypeError, AttributeError)):
        compile_behaviors(["N1-1 N2-0"], [3.5], use_native=use_native)
    with pytest.raises(ValueError, match="No impressions"):
        compile_behaviors([], [], use_native=use_native)


def test_native_is_built_from_the_ports_source_into_build():
    module = native.load()
    assert module.__name__ == "_nrtorch_native"
    assert Path(module.__file__).parent == REPO / "build" / "native"
    assert Path(module.__file__) == native.library_path()


def test_native_falls_back_to_numpy_with_one_warning(monkeypatch):
    def no_compiler():
        raise OSError("g++: not found")

    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.warns(RuntimeWarning, match="using numpy"):
        assert native.load() is None
    assert native.load() is None  # decided once
    impressions, history = CASES["random"]
    _assert_same(compile_behaviors(impressions, history), port_compiler.compile_behaviors(impressions, history, use_native=False))


_CONCURRENT = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from news_recommendation_project_v2_torch import native
native.BUILD_DIR = Path({build!r})
Path({build!r}, "ready{{}}".format(sys.argv[1])).touch()
while not Path({build!r}, "go").exists():
    time.sleep(0.01)
module = native.load()
print(module.compile_behaviors(["N1-1 N2-0"], ["N3"])[0])
"""


def test_native_builds_once_from_two_processes(tmp_path):
    """Two processes that reach the build together: one compiles under the
    file lock, the other waits and loads the same library."""
    script = _CONCURRENT.format(repo=str(REPO), build=str(tmp_path))
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), "a process did not start"
            time.sleep(0.01)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "['N3', 'N1', 'N2']"
    assert [p.name for p in tmp_path.glob("_nrtorch_native-*")] == [native.library_path().name]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_shard_rows_matches_jax(num_hosts, seed):
    impressions, history = CASES["random"]
    c = compile_behaviors(impressions, history)
    jc = jax_compile(impressions, history, use_native=False)
    rows = []
    for host in range(num_hosts):
        got, want = shard_rows(c, host, num_hosts, seed), jax_shard_rows(jc, host, num_hosts, seed)
        _assert_same(got, want)
        rows.append(got.num_rows)
    assert sum(rows) == c.num_rows and max(rows) - min(rows) <= 1


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
def test_partition_rows_by_tokens_matches_jax(parts):
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 6, size=60)
    lens[[5, 31]] = 400  # skewed: single long rows at the cut points
    got = partition_rows_by_tokens(lens, parts)
    np.testing.assert_array_equal(got, jax_partition(lens, parts))
    assert got[0] == 0 and got[-1] == len(lens) and (np.diff(got) >= 0).all()
