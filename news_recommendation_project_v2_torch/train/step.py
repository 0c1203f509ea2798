"""The flat-token train steps of a token-local tower (the latent tower), with
the margin loss or InfoNCE.

The tower runs once over the batch's flat history-token stream ([1, T, D];
the deduped rows' tokens, row-major, padded to a power of two), so no token
is padded inside a row. User vectors come from a sum of each row's tokens and
the tower's own pool epilogue; the pair rows gather them and score the
candidates by cosine. On CUDA the tower's forward runs through both
hand-written kernels, under their ``torch.autograd.Function``s.

Every sum whose order could change from run to run is taken in a fixed
order, so two runs from one state give the same bits on the card: the pool
sums each row's contiguous run of tokens (``torch.segment_reduce``), and the
pair gather's backward sums each row's pair gradients after a stable sort
(``gather_rows``), where ``index_add_`` and an indexing backward would add
with atomics.

A batch is the tuple ``TowerTrainer._epoch_batches_flat`` yields, as tensors
on the tables' device: ``(tok_idx [T], tok_rows [T], lens [U], hist_rev [B],
pos_idx [B], neg_idx [B] or [B, K] with -1 pads, pair_mask [B])``. Tokens
whose row is ``U`` or more are pad and dropped; pair rows with mask 0 are
pad.
"""

from __future__ import annotations

import torch

from ..models.latent_attention import pool_epilogue
from .losses import infonce_loss, margin_ranking_loss


def safe_cosine(u: torch.Tensor, v: torch.Tensor, eps2: float = 1e-16) -> torch.Tensor:
    """Row-wise cosine with finite gradients at zero vectors
    (``sqrt(|x|^2 + eps2)``, not ``norm``)."""
    un = torch.sqrt((u * u).sum(-1) + eps2)
    vn = torch.sqrt((v * v).sum(-1) + eps2)
    return (u * v).sum(-1) / (un * vn)


class _GatherRows(torch.autograd.Function):
    """``src[index]`` whose backward adds each row's gradients in the order
    the rows appear in ``index``: a stable sort, then a segment sum."""

    @staticmethod
    def forward(ctx, src, index):
        ctx.save_for_backward(index)
        ctx.num_rows = src.shape[0]
        return src[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        order = torch.sort(index, stable=True)
        bounds = torch.arange(ctx.num_rows + 1, device=index.device, dtype=index.dtype)
        offsets = torch.searchsorted(order.values, bounds)
        return torch.segment_reduce(grad[order.indices], "sum", offsets=offsets, unsafe=True), None


def gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``src[index]`` for ``index`` in [0, len(src)), with a deterministic
    backward."""
    return _GatherRows.apply(src, index.long())


def flat_user_vectors(
    tower: torch.nn.Module,
    news_emb: torch.Tensor,
    tok_idx: torch.Tensor,
    tok_rows: torch.Tensor,
    lens: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """[U, D] float32 user vectors: the tower per token over
    ``news_emb[tok_idx]``, each row's tokens summed (``tok_rows`` ascending;
    rows of ``U`` or more dropped), then the tower's pool epilogue: the mean
    over ``max(lens, 1)`` tokens and, if ``normalize``, the L2 norm."""
    h = tower(news_emb[tok_idx.long()][None], None)[0].float()
    rows = tok_rows.long()
    bounds = torch.arange(lens.shape[0] + 1, device=rows.device)
    # Row r's tokens are [offsets[r], offsets[r + 1]); the pad tokens after
    # offsets[U] are read by no segment and get a zero gradient.
    acc = torch.segment_reduce(h, "sum", offsets=torch.searchsorted(rows, bounds), unsafe=True)
    return pool_epilogue(acc, lens, normalize)


def flat_margin_loss(tower, news_emb, batch, margin: float) -> torch.Tensor:
    """The margin-ranking loss of one flat batch (graph kept for backward)."""
    tok_idx, tok_rows, lens, hist_rev, pos_idx, neg_idx, pair_mask = batch
    user = flat_user_vectors(tower, news_emb, tok_idx, tok_rows, lens, tower.output_normalize)
    u = gather_rows(user, hist_rev)
    cos_p = safe_cosine(u, news_emb[pos_idx.long()])
    cos_n = safe_cosine(u, news_emb[neg_idx.long()])
    return margin_ranking_loss(cos_p, cos_n, margin, pair_mask)


def flat_infonce_loss(tower, news_emb, batch) -> torch.Tensor:
    """InfoNCE of one flat batch at temperature 1, as the JAX package's
    flat step takes it: each pair's positive against its K negatives, the
    ``-1`` pads masked (graph kept for backward)."""
    tok_idx, tok_rows, lens, hist_rev, pos_idx, neg_idx, pair_mask = batch
    user = flat_user_vectors(tower, news_emb, tok_idx, tok_rows, lens, tower.output_normalize)
    u = gather_rows(user, hist_rev)
    pos_scores = safe_cosine(u, news_emb[pos_idx.long()])
    neg_idx = neg_idx.long()
    neg_valid = (neg_idx >= 0).float()
    neg_e = news_emb[neg_idx.clamp_min(0)]  # [B, K, D]
    un = torch.sqrt((u * u).sum(-1, keepdim=True) + 1e-16)
    nn_ = torch.sqrt((neg_e * neg_e).sum(-1) + 1e-16)
    neg_scores = (u[:, None, :] * neg_e).sum(-1) / (un * nn_)
    return infonce_loss(pos_scores, neg_scores, neg_valid, 1.0, pair_mask)


def _step(optimizer, loss: torch.Tensor) -> torch.Tensor:
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def flat_margin_step(tower, optimizer, news_emb, batch, margin: float) -> torch.Tensor:
    """One optimizer step on the margin loss of ``batch``; returns the loss
    (a tensor on the device: reading it waits for the card)."""
    return _step(optimizer, flat_margin_loss(tower, news_emb, batch, margin))


def flat_infonce_step(tower, optimizer, news_emb, batch) -> torch.Tensor:
    """One optimizer step on the InfoNCE loss of ``batch``; returns the loss
    (a tensor on the device: reading it waits for the card)."""
    return _step(optimizer, flat_infonce_loss(tower, news_emb, batch))
