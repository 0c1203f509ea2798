"""The per-layer metrics that read the port's own spans and counters
(``portbench/spans.py``), in tiny traced cells on the CPU: each reads a
finite percent; the latent cell's real tokens are ``drivers/train.py``'s own count;
without ``--trace 1``, or with a program that records nothing, they read
nothing."""

from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import harness, spans
from portbench.tests import tiny

TRAIN = ["trainer.batch_wait_share.train", "trainer.build_share.train", "trainer.dispatch_share.train",
         "trainer.sync_share.train", "train.pad_share.train"]
CELLS = {"tiny-latent.train": TRAIN, "tiny-transformer.train": TRAIN, "tiny-latent.eval": ["eval.pad_share.eval"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def _fresh():
    from news_recommendation_project_v2_torch.utils import profiling

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.clear()  # one run a process in the benchmark; here, many
    yield
    profiling.clear()
    torch.set_num_threads(before)


def run(root, cell, trace, monkeypatch, seed=2**31 + 11):
    seen = []

    class Kept(harness.Readings):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append(self)

    monkeypatch.setattr(harness, "Readings", Kept)
    out = harness.run_cell(root, cell, seed, 0.3, trace, time.perf_counter(), device="cpu")
    return out, seen


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_tiny_cell_reads_every_new_metric(root, cell, monkeypatch):
    out, seen = run(root, cell, True, monkeypatch)
    assert out["correct"], out["checks"]
    for name in CELLS[cell]:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and 0.0 <= v <= 100.0, (name, v)
    rec = spans.recorded()
    if cell.endswith(".train"):
        (r,) = seen
        assert rec.counters["train.tokens_real"] == r.counters["traced"]["tokens"]
        assert rec.counters["train.pairs"] == r.counters["traced"]["pairs"]
        assert rec.counters["train.steps"] == r.counters["traced"]["calls"]
        loop = sum(out["metrics"][f"trainer.{m}_share.train"]["value"] for m in ("batch_wait", "dispatch", "sync"))
        assert loop <= 100.0


def test_without_trace_the_new_metrics_read_nothing(root, monkeypatch):
    """A run without ``--trace 1`` has no device trace: the readers leave
    the metrics out, records or not."""
    _, seen = run(root, "tiny-latent.train", True, monkeypatch)
    r = harness.Readings(seen[0].cell, seen[0].counters, None)
    for name in TRAIN:
        assert r.cell.reader(name).read(r) is None


def test_a_program_without_the_recorder_reads_nothing(root, monkeypatch):
    """A program older than the recorder has no ``recorded``: each metric
    is left out."""
    from news_recommendation_project_v2_torch.utils import profiling

    _, seen = run(root, "tiny-latent.train", True, monkeypatch)
    r = seen[0]
    monkeypatch.delattr(profiling, "recorded")
    for name in TRAIN:
        assert r.cell.reader(name).read(r) is None
