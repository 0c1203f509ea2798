"""The plain reference against the port on the CPU at small widths, so that
a fault in the reference shows before a run on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.config import HISTORY_BUCKETS
from news_recommendation_project_v2_torch.data.sampling import sample_epoch_pairs
from news_recommendation_project_v2_torch.eval.metrics import score_row
from portbench import check, generate, port, weights
from portbench.reference import latent, metrics, train, transformer
from portbench.reference.common import Precision, round_mantissa
from portbench.tests.tiny import BEHAVIORS, TOWERS

SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tower(name):
    tower = TOWERS[name]
    mod = {"latent": latent, "transformer": transformer}[tower["kind"]]
    params = weights.make_params(mod.param_shapes(tower), weights.device_generator(SEED, 3, "cpu"), "cpu")
    return tower, mod, params, port.build_tower({"tower": tower}, params, "cpu")


def _padded(lens, dim, gen):
    x = torch.randn(len(lens), max(lens), dim, generator=gen)
    mask = (torch.arange(max(lens))[None, :] < torch.tensor(lens)[:, None]).float()
    return x * mask[..., None], mask


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_reference_users_equal_the_ports(name):
    tower, mod, params, port_tower = _tower(name)
    x, mask = _padded([5, 1, 9, 3], tower["reduced_dim"], torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = port_tower(x, mask)
        got = mod.users_padded(params, tower, x, mask, Precision())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def test_reference_dropout_draws_the_ports_masks():
    tower, mod, params, port_tower = _tower("tiny-transformer")
    x, mask = _padded([5, 2, 7], tower["reduced_dim"], torch.Generator().manual_seed(2))
    rows = 8  # the padded batch's rows, of which the first 3 are real
    xb = torch.cat([x, torch.zeros(rows - 3, *x.shape[1:])])
    mb = torch.cat([mask, torch.zeros(rows - 3, mask.shape[1])])
    want = port_tower(xb, mb, generator=torch.Generator().manual_seed(5))[:3]
    stream = transformer.DropoutStream(torch.Generator().manual_seed(5), rows, tower["dropout_rate"])
    got = mod.users_padded(params, tower, x, mask, Precision(), stream)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def test_flat_users_equal_padded_users():
    tower, mod, params, _ = _tower("tiny-latent")
    x, mask = _padded([4, 6, 1], tower["reduced_dim"], torch.Generator().manual_seed(3))
    padded = mod.users_padded(params, tower, x, mask, Precision())
    flat = mod.users_flat(params, tower, x[mask.bool()], mask.sum(1).long(), Precision())
    torch.testing.assert_close(flat, padded)


def test_the_reference_sampler_draws_the_ports_pairs():
    d = generate.behaviors(generate.seed_rng(SEED, 1), 400, 700, BEHAVIORS)
    for batch in (64, 10_000):
        want, _ = sample_epoch_pairs(np.random.default_rng(SEED), d.imp_rev, d.imp_lens, d.labels, batch_size=batch)
        got = train.epoch_pairs(np.random.default_rng(SEED), d.imp_rev, d.imp_lens, d.labels, batch)
        np.testing.assert_array_equal(got, want)
    assert train.pairs_per_epoch(d.imp_lens, d.labels) == want.shape[1]


def test_reference_metrics_equal_the_ports_host_metrics_and_a_pair_count():
    rng = np.random.default_rng(4)
    lens = rng.integers(2, 12, size=50)
    scores = np.round(rng.standard_normal(lens.sum()), 1)  # ties on purpose
    labels = (rng.random(lens.sum()) < 0.3).astype(np.int8)
    ends = np.cumsum(lens)
    labels[ends - lens], labels[ends - 1] = 1, 0
    got = metrics.impression_metrics(scores, labels, lens)
    for i, (e, n) in enumerate(zip(ends, lens)):
        s, y = scores[e - n : e], labels[e - n : e]
        # score_row takes dense ranks (1 = best); ties share a rank.
        ranks = np.unique(-s, return_inverse=True)[1] + 1
        np.testing.assert_allclose(got[i], score_row(y.tolist(), ranks.tolist()), rtol=1e-12, atol=1e-12)
        pos, neg = s[y == 1], s[y == 0]
        pairs = (pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()
        assert got[i][0] == pytest.approx(pairs / (len(pos) * len(neg)))


def test_rounding_to_tf32_and_bfloat16():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-9), 3.0], requires_grad=True)
    assert round_mantissa(x, 10).tolist() == [1.0, 1.0 + 2.0**-9, -(1.0 + 2.0**-9), 3.0]
    torch.testing.assert_close(round_mantissa(x, 7), x.detach().to(torch.bfloat16).float())
    round_mantissa(x, 10).sum().backward()
    assert x.grad.tolist() == [1.0] * 4


def test_the_first_steps_follow_the_ports_trainer():
    """The reference's three steps against ``TowerTrainer``'s first three,
    both towers, from the same weights and behaviours."""
    from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

    for name in sorted(TOWERS):
        tower, mod, params, port_tower = _tower(name)
        flat = tower["kind"] == "latent"
        d = generate.behaviors(generate.seed_rng(SEED, 1), 80, 300, BEHAVIORS)
        table = weights.news_table(300, tower["reduced_dim"], weights.device_generator(SEED, 2, "cpu"), "cpu")
        cfg = {"learning_rate": 1e-3, "weight_decay": 0.01, "grad_clip_norm": 0.5, "margin": 2.0, "batch_size": 32,
               "loss": "margin", "loss_sync_every": 1}
        trainer = TowerTrainer(port_tower, port.compiled(d, 300), table, cfg=port.train_config({"train": cfg}, SEED),
                               flat_train=flat, flat_eval=flat, device="cpu")
        losses = []
        for _, batch in trainer._host_batches():
            losses.append(float(trainer._train_step(batch)))
            if len(losses) == 3:
                break
        gen = torch.Generator().manual_seed(SEED) if not flat else None
        ref = train.follow(mod, params, tower, cfg, table, d, SEED, 3, Precision(), 600, HISTORY_BUCKETS, gen)
        np.testing.assert_allclose(ref["losses"], losses, rtol=2e-6)
        # Adam's first steps move an element whose gradient is near nought
        # (the key's bias under the softmax) by round-off, so the parameters
        # are held leaf by leaf, by the norm of their change, over the elements
        # the gradient moves (the readout's bias cancels in its normalisation).
        got = {k: p.detach() - params[k] for k, p in port_tower.named_parameters()}
        want = {k: ref["params"][k] - params[k] for k in params}
        gap, leaf = check.leaf_norm_gap(got, want, check.moved_elements(ref["grad1"]))
        assert gap < 1e-4, leaf
