"""Whole runs of tiny cells on the CPU, the harness's look for a chip
skipped: a cell added by files and entries alone runs and comes out
correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have."""

from __future__ import annotations

import filecmp
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = ["tiny-latent.train", "tiny-transformer.train", "tiny-latent.eval"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(root, cell, trace=False, seed=2**31 + 5):
    return harness.run_cell(root, cell, seed, 0.3, trace, time.perf_counter(), device="cpu")


def test_new_cells_need_new_files_and_entries_only(root):
    """The tiny cells' checkout holds every file of the benchmark unchanged."""
    src = tiny.ROOT / "portbench"
    for path in src.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and "tests" not in path.parts:
            assert filecmp.cmp(path, root / path.relative_to(tiny.ROOT), shallow=False), path


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_correct(root, cell, trace):
    r = run(root, cell, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    if trace:
        assert "breakdown" in r and "busy_s" in r["device"]
        assert r["metrics"] and "setup_s" not in r["metrics"]
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def _state_unchanged(mp):
    from news_recommendation_project_v2_torch.train.trainer import ClippedAdamW

    mp.setattr(ClippedAdamW, "step", lambda self, closure=None: None)


def _half_batch_train(mp):
    from news_recommendation_project_v2_torch.train import step

    real = step.margin_ranking_loss

    def half(pos, neg, margin=2.0, pair_mask=None):
        keep = pair_mask.clone()
        live = torch.nonzero(keep).flatten()
        keep[live[len(live) // 2 :]] = 0
        return real(pos, neg, margin, keep)

    mp.setattr(step, "margin_ranking_loss", half)


def _token_altered_train(mp):
    from news_recommendation_project_v2_torch.train import step

    real = step.gather_rows

    def altered(src, index):
        out = real(src, index)
        return out + (torch.arange(out.shape[0]) == 0)[:, None] * 0.5 if out.dim() == 2 else out

    mp.setattr(step, "gather_rows", altered)


def _half_batch_eval(mp):
    from news_recommendation_project_v2_torch.ops import scoring

    real = scoring.metric_sums

    def half(full_scores, grids):
        grids = tuple(g._replace(lens=g.lens * (torch.arange(g.lens.shape[1]) < g.lens.shape[1] // 2)) for g in grids)
        return real(full_scores, grids)

    mp.setattr(scoring, "metric_sums", half)


def _answer_altered_eval(mp):
    from news_recommendation_project_v2_torch.ops import scoring

    real = scoring._cosine

    def altered(u, c):
        out = real(u, c)  # the first impression's scores turned upside down
        return torch.where(torch.arange(out.shape[0]) < 8, -out, out)

    mp.setattr(scoring, "_cosine", altered)


FAULTS = [
    ("tiny-latent.train", _state_unchanged),
    ("tiny-latent.train", _half_batch_train),
    ("tiny-latent.train", _token_altered_train),
    ("tiny-transformer.train", _state_unchanged),
    ("tiny-transformer.train", _half_batch_train),
    ("tiny-latent.eval", _half_batch_eval),
    ("tiny-latent.eval", _answer_altered_eval),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_comes_out_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root, cell)
    assert not r["correct"], r["checks"]
