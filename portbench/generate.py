"""The traffic generator: MIND-like behaviours from a seed and a traffic
file's parameters.

Behaviours follow ``bench.py``'s ``build_workload`` (the pattern every
earlier figure of the port used): a history length per row drawn from a
geometric distribution (``mean_history``, capped at ``history_cap``), a
candidate count from a Poisson distribution (``mean_candidates``, clipped to
``[min_candidates, max_candidates]``), news ids uniform over the table, and
clicks at ``click_rate`` with the first candidate of every impression
clicked and the last not, so each impression holds both classes. The
lengths and counts come from a fixed stream, and every seed takes them in
an order of its own: every run of a cell does the same work.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Behaviors:
    """Rows of impressions with click histories, as flat arrays."""

    hist_lens: np.ndarray  # [rows] int32
    hist_rev: np.ndarray  # [sum(hist_lens)] int32 news rows
    imp_lens: np.ndarray  # [rows] int32
    imp_rev: np.ndarray  # [sum(imp_lens)] int32 news rows
    labels: np.ndarray  # [sum(imp_lens)] int8

    @property
    def rows(self) -> int:
        return len(self.imp_lens)


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one of a run's streams of draws."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def behaviors(rng: np.random.Generator, rows: int, news: int, p: dict) -> Behaviors:
    """``rows`` impressions over a table of ``news`` rows, by ``p``'s
    distribution parameters."""
    sizes = seed_rng(0, 99)
    hist_lens = np.minimum(sizes.geometric(1.0 / p["mean_history"], size=rows), p["history_cap"]).astype(np.int32)
    imp_lens = np.clip(sizes.poisson(p["mean_candidates"], size=rows), p["min_candidates"], p["max_candidates"])
    imp_lens = imp_lens.astype(np.int32)
    order = rng.permutation(rows)
    hist_lens, imp_lens = hist_lens[order], imp_lens[order]
    hist_rev = rng.integers(0, news, size=int(hist_lens.sum())).astype(np.int32)
    imp_rev = rng.integers(0, news, size=int(imp_lens.sum())).astype(np.int32)
    labels = (rng.random(len(imp_rev)) < p["click_rate"]).astype(np.int8)
    ends = np.cumsum(imp_lens)
    labels[ends - imp_lens] = 1
    labels[ends - 1] = 0
    return Behaviors(hist_lens, hist_rev, imp_lens, imp_rev, labels)
