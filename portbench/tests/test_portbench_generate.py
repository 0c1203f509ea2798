"""The traffic generator and the weights: deterministic by seed."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import generate, weights
from portbench.reference import latent
from portbench.tests.tiny import ROOT

MIXES = {p.stem: json.loads(p.read_text()) for p in (ROOT / "portbench" / "traffic").glob("*.json")}
SEED = 2**31 + 12345


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_behaviors_are_the_same_for_a_seed_and_differ_across_seeds(mix):
    p = MIXES[mix]["behaviors"]
    a = generate.behaviors(generate.seed_rng(SEED, 1), 300, 1000, p)
    b = generate.behaviors(generate.seed_rng(SEED, 1), 300, 1000, p)
    c = generate.behaviors(generate.seed_rng(SEED + 1, 1), 300, 1000, p)
    for x, y in zip(a.__dict__.values(), b.__dict__.values()):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.hist_rev[:50], c.hist_rev[:50])
    # Every seed takes the same lengths and counts, in an order of its own.
    np.testing.assert_array_equal(np.sort(a.hist_lens), np.sort(c.hist_lens))
    np.testing.assert_array_equal(np.sort(a.imp_lens), np.sort(c.imp_lens))
    assert not np.array_equal(a.hist_lens, c.hist_lens)


def test_behaviors_keep_their_bounds_and_both_classes():
    p = MIXES["train"]["behaviors"]
    d = generate.behaviors(generate.seed_rng(SEED, 1), 2000, 65238, p)
    assert d.hist_lens.min() >= 1 and d.hist_lens.max() <= p["history_cap"]
    assert d.imp_lens.min() >= p["min_candidates"] and d.imp_lens.max() <= p["max_candidates"]
    assert abs(d.hist_lens.mean() - p["mean_history"]) < 3 and abs(d.imp_lens.mean() - p["mean_candidates"]) < 1
    ends = np.cumsum(d.imp_lens)
    assert (d.labels[ends - d.imp_lens] == 1).all() and (d.labels[ends - 1] == 0).all()
    assert 0.15 < d.labels.mean() < 0.3
    assert d.hist_rev.max() < 65238 and d.imp_rev.min() >= 0


def test_weights_and_table_are_the_same_for_a_seed():
    tower = json.loads((ROOT / "portbench" / "configs" / "latent-e5large.json").read_text())["tower"]
    tower = dict(tower, reduced_dim=32, hidden_dim=128, num_latents=8, latent_dim_head=16)
    shapes = latent.param_shapes(tower)
    a = weights.make_params(shapes, weights.device_generator(SEED, 3, "cpu"), "cpu")
    b = weights.make_params(shapes, weights.device_generator(SEED, 3, "cpu"), "cpu")
    c = weights.make_params(shapes, weights.device_generator(SEED + 1, 3, "cpu"), "cpu")
    for k in shapes:
        assert a[k].shape == shapes[k][0]
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["latents"], c["latents"])
    t = weights.news_table(100, 32, weights.device_generator(SEED, 2, "cpu"), "cpu")
    torch.testing.assert_close(torch.linalg.vector_norm(t, dim=-1), torch.ones(100))
