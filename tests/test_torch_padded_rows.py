"""The padded train step over a batch's real rows, on the CPU: the
one-device padded feed (``TowerTrainer._host_batches``) hands over the
history block's U deduped rows, the first U rows of ``_epoch_batches``'
``[B, L]`` block, and keeps a real row whose history is empty; the joint
trainer's and the flat route's batches keep their shapes; a step over the U
rows gives the loss and the gradients of the step over all B rows, dropout
on, and leaves the generator where that step leaves it; a
``layers.BatchDraw`` draw of U rows is the first U rows of a draw of B."""

import dataclasses

import numpy as np
import pytest
import torch

from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.grouping import lengths_to_offsets
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import WeightedSumModel, build_tower
from news_recommendation_project_v2_torch.models.layers import BatchDraw, dropout
from news_recommendation_project_v2_torch.train.step import apply_step, padded_infonce_loss, padded_margin_loss
from news_recommendation_project_v2_torch.train.trainer import JointTowerTrainer, TowerTrainer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
B = 64
TOWERS = {
    "transformer": dict(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=1, dropout_rate=0.1),
    "final_attention": dict(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=64, dropout_rate=0.1),
}
LATENT = dict(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, latent_dim_head=16)
LOSSES = ("margin", "infonce")


@pytest.fixture(scope="module")
def data():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=120, num_rows=240, dim=D, noise=0.05, seed=3)
    ct = compile_behaviors(imps, hist).with_history_view()
    return ct, align_embeddings(ct.news_ids, emb)


def _cfg(loss="margin") -> TrainConfig:
    return TrainConfig(learning_rate=3e-4, batch_size=B, seed=0, loss=loss, num_neg_per_pos=3)


def _tower(kind):
    torch.manual_seed(0)
    return build_tower(TowerConfig(**(LATENT if kind == "latent" else TOWERS[kind])))


def _trainer(data, kind="transformer", loss="margin") -> TowerTrainer:
    ct, emb = data
    return TowerTrainer(_tower(kind), ct, emb, cfg=_cfg(loss), flat_train=False, flat_eval=False, device="cpu")


def _epoch(trainer, build):
    """The epoch's pairs, ``build``'s batches and ``_host_batches``' (as
    numpy), each from the same state of the trainer's sampler."""
    state = trainer.rng.bit_generator.state
    pairs, _ = trainer._epoch_pairs()
    trainer.rng.bit_generator.state = state
    built = list(build())
    trainer.rng.bit_generator.state = state
    fed = [tuple(t.numpy() for t in b) for _, b in trainer._host_batches()]
    return pairs, built, fed


def _deduped_rows(pairs, i):
    return np.unique(pairs[-1, i * B : (i + 1) * B])


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", list(TOWERS))
def test_the_padded_feed_hands_over_the_real_rows(data, kind, loss):
    trainer = _trainer(data, kind, loss)
    pairs, padded, fed = _epoch(trainer, trainer._epoch_batches)
    assert len(fed) == len(padded) == -(-pairs.shape[1] // B) > 1
    for i, (full, got) in enumerate(zip(padded, fed)):
        rows = len(_deduped_rows(pairs, i))
        assert full[0].shape == full[1].shape == (B, full[0].shape[1])
        assert got[0].shape == got[1].shape == (rows, full[0].shape[1])
        assert rows < B
        np.testing.assert_array_equal(got[0], full[0][:rows])
        np.testing.assert_array_equal(got[1], full[1][:rows])
        assert not full[0][rows:].any() and not full[1][rows:].any()
        assert len(got) == len(full)
        for g, f in zip(got[2:], full[2:]):
            np.testing.assert_array_equal(g, f)


def _without_history(ct, row):
    """``ct`` with ``row``'s history emptied: the row stays, its length 0."""
    offsets = lengths_to_offsets(ct.hist_lens)
    keep = np.ones(len(ct.hist_rev), bool)
    keep[offsets[row] : offsets[row + 1]] = False
    lens = ct.hist_lens.copy()
    lens[row] = 0
    return dataclasses.replace(ct, hist_rev=ct.hist_rev[keep], hist_row=ct.hist_row[keep], hist_lens=lens)


def test_a_real_row_with_an_empty_history_keeps_its_row(data):
    """The epoch's largest row is the last of its batch's deduped rows; with
    its history emptied its mask row is all 0, and the block still holds it."""
    ct, emb = data
    trainer = _trainer(data)
    row = int(trainer._epoch_pairs()[0][-1].max())
    trainer = _trainer((_without_history(ct, row), emb))
    pairs, padded, fed = _epoch(trainer, trainer._epoch_batches)
    held = 0
    for i, (full, got) in enumerate(zip(padded, fed)):
        rows = _deduped_rows(pairs, i)
        assert got[1].shape[0] == len(rows)
        if rows[-1] != row:
            continue
        held += 1
        assert not got[1][-1].any() and got[1][:-1].any(axis=1).all()
        real = int(full[-1].sum())
        assert (got[2][:real] == len(rows) - 1).any()  # a pair reads the empty row
    assert held == 1


def test_the_joint_and_flat_feeds_keep_their_shapes(data):
    ct, emb = data
    joint = JointTowerTrainer(
        _tower("final_attention"), ct, emb, blend=WeightedSumModel(), baseline_train=np.zeros(ct.num_news, np.float32),
        cfg=_cfg(), flat_eval=False, device="cpu",
    )
    _, padded, fed = _epoch(joint, joint._epoch_batches)
    assert len(fed) == len(padded) > 1
    for full, got in zip(padded, fed):
        assert got[0].shape == got[1].shape == full[0].shape == (B, full[0].shape[1])
        for g, f in zip(got, full):
            np.testing.assert_array_equal(g, f)
    flat = TowerTrainer(_tower("latent"), ct, emb, cfg=_cfg(), device="cpu")
    _, built, fed = _epoch(flat, flat._epoch_batches_flat)
    assert len(fed) == len(built) > 1
    for want, got in zip(built, fed):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _loss_fn(trainer):
    cfg = trainer.cfg
    if cfg.loss == "infonce":
        return lambda tower, news, batch, gen: padded_infonce_loss(tower, news, batch, gen)
    return lambda tower, news, batch, gen: padded_margin_loss(tower, news, batch, cfg.margin, gen)


@pytest.mark.parametrize("loss", LOSSES)
def test_a_step_over_the_real_rows_is_the_step_over_all(data, loss):
    """One batch, dropout 0.1, from one generator seed: the loss over the fed
    ``[U, L]`` block with a ``BatchDraw`` of B rows against the loss over
    ``_epoch_batches``' ``[B, L]`` block with the generator itself; then the
    trainer's own step on the fed block against that whole-block step."""
    trainer = _trainer(data, "transformer", loss)
    state = trainer.rng.bit_generator.state
    full = tuple(torch.from_numpy(a) for a in next(trainer._epoch_batches()))
    trainer.rng.bit_generator.state = state
    fed = next(trainer._host_batches())[1]
    assert fed[0].shape[0] < B == full[0].shape[0]
    step_loss, params = _loss_fn(trainer), list(trainer.tower.parameters())

    def grads(batch, draw):
        gen = torch.Generator().manual_seed(5)
        value = step_loss(trainer.tower, trainer.news_emb_train, batch, draw(gen))
        return value.detach(), torch.autograd.grad(value, params), gen.get_state()

    loss_all, grads_all, gen_all = grads(full, lambda g: g)
    loss_fed, grads_fed, gen_fed = grads(fed, lambda g: BatchDraw(g, B))
    assert float(loss_fed) == pytest.approx(float(loss_all), rel=1e-6, abs=1e-7)
    for (name, _), a, b in zip(trainer.tower.named_parameters(), grads_fed, grads_all):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-7, name
    assert torch.equal(gen_fed, gen_all)

    # The trainer's step on the fed block, against the whole block's step from the same state: the
    # gradient each took, read from Adam's first moment (Adam's first update is about lr x the
    # gradient's sign, which round-off flips where a gradient is near nought).
    other = _trainer(data, "transformer", loss)
    trainer.generator.manual_seed(11)
    other.generator.manual_seed(11)
    got = trainer._train_step(fed)
    want = apply_step(other.optimizer, step_loss(other.tower, other.news_emb_train, full, other.generator))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    for (name, a), b in zip(trainer.tower.named_parameters(), other.tower.parameters()):
        m_got, m_want = trainer.optimizer.state[a]["exp_avg"], other.optimizer.state[b]["exp_avg"]
        assert float((m_got - m_want).norm()) <= 1e-5 * float(m_want.norm()) + 1e-8, name
    assert torch.equal(trainer.generator.get_state(), other.generator.get_state())


@pytest.mark.parametrize("rows", [1, 17, B])
def test_a_batch_draw_is_the_first_rows_of_the_whole_draw(rows):
    shape = (rows, 7, 5)
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    draw = BatchDraw(a, B).rand(torch.Size(shape), torch.device("cpu"))
    assert draw.shape == shape
    assert torch.equal(draw, torch.rand((B, 7, 5), generator=b)[:rows])
    assert torch.equal(a.get_state(), b.get_state())
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    whole = torch.cat([x, torch.ones(B - rows, 7, 5)])
    got = dropout(x, 0.1, BatchDraw(a, B))
    want = dropout(whole, 0.1, b)[:rows]
    assert torch.equal(got, want) and (got == 0).any()
    assert torch.equal(a.get_state(), b.get_state())
    # The plain forms as before: none is the identity, a generator draws over the block itself.
    assert dropout(x, 0.1, None) is x
    c, d = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    keep = torch.rand(shape, generator=d) < 0.9
    assert torch.equal(dropout(x, 0.1, c), torch.where(keep, x / 0.9, torch.zeros_like(x)))
