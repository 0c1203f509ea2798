"""The training step in plain PyTorch and numpy: the epoch's pair sampling,
each batch's users, the margin-ranking loss on cosine scores, the backward,
and a global-norm clip followed by AdamW.

The sampler follows the reference repository's ``data_utils.py:345-388``
and ``reset()`` (``:624-645``) as the trainers run it, drawing from one
``numpy.random.Generator`` seeded with the training seed in this order: per
impression, the positives and the negatives brought to ``max(pos, neg)``
each (a random order of the side's items, the first ``target`` kept, the
rest drawn with replacement, then shuffled within the impression), the
negatives second; then a random order of the impressions, and a random
order of the whole batches but the last. A batch is ``batch_size``
consecutive pairs of that stream; its users are its distinct rows in
ascending order, each the most recent ``history_cap`` clicks of the row.

The step: ``loss = mean(max(0, margin - cos(u, pos) + cos(u, neg)))`` over
the batch's pairs; the gradients scaled by ``max_norm / norm`` where their
global norm reaches ``max_norm``; then AdamW (betas 0.9 and 0.999, eps
1e-8, decoupled weight decay on every parameter).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .common import Precision, cosine

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _offsets(lens: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64))])


def _equalize(rng: np.random.Generator, vals: np.ndarray, counts: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per impression, ``target`` of its side's values: a random order of
    them, the first ``target`` kept, any more drawn with replacement, and
    the whole shuffled."""
    segs = np.repeat(np.arange(len(counts)), counts)
    perm = vals[np.argsort(segs + rng.random(len(vals)))]
    off, t_off = _offsets(counts), _offsets(targets)
    total = int(t_off[-1])
    seg_out = np.repeat(np.arange(len(counts)), targets)
    slot = np.arange(total) - np.repeat(t_off[:-1], targets)
    cnt = counts[seg_out]
    base = np.repeat(off[:-1], targets)
    take = base + np.minimum(slot, np.maximum(cnt - 1, 0))
    extra = slot >= cnt
    if extra.any():
        draws = rng.integers(0, np.iinfo(np.int64).max, size=int(extra.sum()))
        take[extra] = base[extra] + draws % cnt[extra]
    out = perm[take]
    return out[np.argsort(seg_out + rng.random(total))]


def epoch_pairs(rng: np.random.Generator, imp_rev, imp_lens, labels, batch_size: int) -> np.ndarray:
    """One epoch's pair stream, [3, pairs]: (positive, negative, row)."""
    imp_lens = np.asarray(imp_lens, np.int64)
    row = np.repeat(np.arange(len(imp_lens)), imp_lens)
    is_pos = np.asarray(labels) == 1
    n_pos = np.bincount(row[is_pos], minlength=len(imp_lens)).astype(np.int64)
    n_neg = imp_lens - n_pos
    targets = np.maximum(n_pos, n_neg)
    pos = _equalize(rng, imp_rev[is_pos], n_pos, targets)
    neg = _equalize(rng, imp_rev[~is_pos], n_neg, targets)
    pairs = np.stack([pos, neg, np.repeat(np.arange(len(imp_lens)), targets)]).astype(np.int64)
    # A random order of the impressions, then of the whole batches but the last.
    order_imp = rng.permutation(len(imp_lens))
    off = _offsets(targets)
    new_counts = targets[order_imp]
    new_off = _offsets(new_counts)
    within = np.arange(pairs.shape[1]) - np.repeat(new_off[:-1], new_counts)
    order = np.repeat(off[:-1][order_imp], new_counts) + within
    total = pairs.shape[1]
    n_batches = -(-total // batch_size)
    if n_batches > 1:
        blocks = np.concatenate([rng.permutation(n_batches - 1), [n_batches - 1]])
        index = np.concatenate([np.arange(b * batch_size, (b + 1) * batch_size) for b in blocks])
        order = order[index[index < total]]
    return pairs[:, order]


def pairs_per_epoch(imp_lens, labels) -> int:
    """The pairs one epoch trains on: ``max(positives, negatives)`` an
    impression."""
    imp_lens = np.asarray(imp_lens, np.int64)
    row = np.repeat(np.arange(len(imp_lens)), imp_lens)
    n_pos = np.bincount(row[np.asarray(labels) == 1], minlength=len(imp_lens))
    return int(np.maximum(n_pos, imp_lens - n_pos).sum())


def batch_users(
    tower_mod, params: dict, tower: dict, table: torch.Tensor, hist_rev, hist_lens, rows: np.ndarray,
    history_cap: int, buckets: tuple, prec: Precision, dropout=None,
) -> torch.Tensor:
    """[len(rows), D] user vectors of ``rows`` (ascending, distinct): each
    row's most recent ``history_cap`` clicks, left-justified in one padded
    block as wide as the bucket of the longest."""
    ends = _offsets(hist_lens)[rows + 1]
    lens = np.minimum(np.asarray(hist_lens)[rows], history_cap).astype(np.int64)
    width = next((b for b in buckets if lens.max() <= b), buckets[-1])
    pos = np.arange(width)
    valid = pos[None, :] < lens[:, None]
    idx = np.where(valid, np.asarray(hist_rev)[np.minimum((ends - lens)[:, None] + pos, len(hist_rev) - 1)], 0)
    dev = table.device
    mask = torch.as_tensor(valid, dtype=torch.float32, device=dev)
    x = table[torch.as_tensor(idx, device=dev)] * mask[..., None]
    return tower_mod.users_padded(params, tower, x, mask, prec, dropout)


def margin_loss(user, table, rev, pos, neg, margin: float, keep: Optional[np.ndarray] = None) -> torch.Tensor:
    """The mean hinge ``max(0, margin - cos(u, pos) + cos(u, neg))`` over the
    pairs (those where ``keep`` is True, if given)."""
    dev = table.device
    if keep is not None:
        rev, pos, neg = rev[keep], pos[keep], neg[keep]
    u = user[torch.as_tensor(rev, device=dev)]
    cp = cosine(u, table[torch.as_tensor(pos, device=dev)], 0.0)
    cn = cosine(u, table[torch.as_tensor(neg, device=dev)], 0.0)
    return torch.clamp_min(margin - cp + cn, 0.0).mean()


class ClippedAdamW:
    """A global-norm clip, then AdamW, over a dict of leaves."""

    def __init__(self, params: dict, lr: float, weight_decay: float, max_norm: float):
        self.params, self.lr, self.wd, self.max_norm = params, lr, weight_decay, max_norm
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = 1.0 if norm < self.max_norm else self.max_norm / norm
        clipped = {k: g * scale for k, g in grads.items()}
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.params.items():
            g = clipped[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1**self.t)
            v_hat = self.v[k] / (1.0 - b2**self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        return clipped


def follow(
    tower_mod, init: dict, tower: dict, train: dict, table: torch.Tensor, data, seed: int, steps: int,
    prec: Precision, history_cap: int, buckets: tuple,
    generator: Optional[torch.Generator] = None, pair_filter: Optional[Callable[[int], np.ndarray]] = None,
) -> dict:
    """The first ``steps`` steps of the first epoch from ``init``: each
    step's loss, the first step's clipped gradient and the parameters after
    the last. ``generator`` draws the dropout masks where the tower has
    dropout; ``pair_filter(n)`` (a fault) keeps a subset of a batch's
    ``n`` pairs."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    opt = ClippedAdamW(params, train["learning_rate"], train["weight_decay"], train["grad_clip_norm"])
    rng = np.random.default_rng(seed)
    pairs = epoch_pairs(rng, data.imp_rev, data.imp_lens, data.labels, train["batch_size"])
    rate = tower.get("dropout_rate", 0.0) if generator is not None else 0.0
    losses, grad1 = [], None
    b = train["batch_size"]
    for s in range(steps):
        pos, neg, rows = pairs[:, s * b : (s + 1) * b]
        uniq, rev = np.unique(rows, return_inverse=True)
        dropout = None if not rate else _dropout_stream(tower_mod, generator, b, rate)
        user = batch_users(
            tower_mod, params, tower, table, data.hist_rev, data.hist_lens, uniq, history_cap, buckets, prec, dropout
        )
        keep = None if pair_filter is None else pair_filter(len(rows))
        loss = margin_loss(user, table, rev, pos, neg, train["margin"], keep)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        clipped = opt.step(grads)
        if s == 0:
            grad1 = {k: g.detach().clone() for k, g in clipped.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params": {k: v.detach() for k, v in params.items()}}


def _dropout_stream(tower_mod, generator, rows: int, rate: float):
    stream = getattr(tower_mod, "DropoutStream", None)
    return None if stream is None else stream(generator, rows, rate)
