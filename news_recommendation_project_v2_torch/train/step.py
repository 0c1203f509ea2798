"""The train steps: the user tower's margin and InfoNCE steps, by the flat
token stream (token-local towers) or over padded histories (every tower),
the joint step (the tower with a score blender and/or a dimension reducer),
and the content scorer's steps.

The flat steps run the tower once over the batch's flat history-token
stream ([1, T, D]; the deduped rows' tokens, row-major, padded to a power of
two), so no token is padded inside a row. User vectors come from a sum of
each row's tokens and the tower's own pool epilogue. A flat batch is the
tuple ``TowerTrainer._epoch_batches_flat`` yields: ``(tok_idx [T], tok_rows
[T], lens [U], hist_rev [B], pos_idx [B], neg_idx [B] or [B, K] with -1
pads, pair_mask [B])``; tokens whose row is ``U`` or more are pad.

The padded steps run the tower over the batch's deduped histories padded to
one bucket, ``[U, L]`` with their mask, as ``TowerTrainer._host_batches``
hands them over (``_epoch_batches`` pads the block to ``[B, L]``, rows
past U all pad, and the mesh steps take a rank's rows of that): ``(hist_idx
[U, L], hist_mask [U, L], hist_rev [B], pos_idx, neg_idx, pair_mask)``.
Dropout, where the tower has it, draws its masks from the generator the
trainer passes, or from a ``models.layers.BatchDraw`` that draws over a
batch's ``B`` rows for a block of its first U.

The end-to-end steps (config[2]) learn the news vectors too: a token
encoder (``models.TokenAttentionPool``) turns the frozen per-token states of
a batch's M distinct news into ``news_vecs`` [M, D], and the histories, the
positives and the negatives all index those rows. A streamed batch is
``(token_states [M, T, D], token_mask [M, T], hist_idx [U, L], hist_mask,
hist_rev [B], pos_idx [B], neg_idx, pair_mask)``, as
``EndToEndTrainer._epoch_batches`` builds it; the ``_gathered`` forms take
``(tok_idx [M, T], tok_mask, ...)`` and gather the block from the store
resident on the card.

In all of them, the pair rows gather the user vectors and score the
candidates by cosine; pair rows with mask 0 are pad. The tower steps take
two tables, as the JAX package's do: ``news_emb`` holds the candidates (the
positives and negatives) and ``query_emb`` the history tokens the tower
reads (e5's instruction-prefixed encodings, which ``save_emb`` writes beside
the passage table); ``query_emb=None`` is ``news_emb``. On CUDA the latent
tower's forward runs through both hand-written kernels, under their
``torch.autograd.Function``s.

Every sum whose order could change from run to run is taken in a fixed
order, so two runs from one state give the same bits on the card: the flat
pool sums each row's contiguous run of tokens (``torch.segment_reduce``),
and every row gather's backward (the pair rows' user vectors, the
end-to-end steps' histories and candidates) sums each row's gradients after
a stable sort (``gather_rows``), where ``index_add_`` and an indexing
backward would add with atomics.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.latent_attention import pool_epilogue
from ..models.layers import BatchDraw
from ..ops.encode import gathered_token_states
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
    """``src[index]`` for ``index`` (any shape) in [0, len(src)), with a
    deterministic backward."""
    flat = _GatherRows.apply(src, index.reshape(-1).long())
    return flat.reshape(*index.shape, *src.shape[1:])


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


def padded_user_vectors(
    tower: torch.nn.Module,
    news_emb: torch.Tensor,
    hist_idx: torch.Tensor,
    hist_mask: torch.Tensor,
    generator: Optional[torch.Generator | BatchDraw] = None,
    reduce: Optional[torch.nn.Module] = None,
) -> torch.Tensor:
    """[U, D] user vectors of padded histories: ``news_emb[hist_idx]``
    (through ``reduce`` where given), masked, through the tower."""
    gathered = news_emb[hist_idx.long()]
    if reduce is not None:
        gathered = reduce(gathered)
    gathered = gathered * hist_mask[..., None].to(gathered.dtype)
    return tower(gathered, hist_mask, generator=generator)


def _pair_margin_loss(user, news_emb, hist_rev, pos_idx, neg_idx, pair_mask, margin: float) -> torch.Tensor:
    u = gather_rows(user, hist_rev)
    cos_p = safe_cosine(u, gather_rows(news_emb, pos_idx))
    cos_n = safe_cosine(u, gather_rows(news_emb, neg_idx))
    return margin_ranking_loss(cos_p, cos_n, margin, pair_mask)


def _pair_infonce_loss(user, news_emb, hist_rev, pos_idx, neg_idx, pair_mask) -> torch.Tensor:
    """Each pair's positive against its K negatives at temperature 1, the
    ``-1`` pads masked (the JAX package's ``_infonce_from_vecs``)."""
    u = gather_rows(user, hist_rev)
    pos_scores = safe_cosine(u, gather_rows(news_emb, pos_idx))
    neg_idx = neg_idx.long()
    neg_valid = (neg_idx >= 0).float()
    neg_e = gather_rows(news_emb, neg_idx.clamp_min(0))  # [B, K, D]
    un = torch.sqrt((u * u).sum(-1, keepdim=True) + 1e-16)
    nn_ = torch.sqrt((neg_e * neg_e).sum(-1) + 1e-16)
    neg_scores = (u[:, None, :] * neg_e).sum(-1) / (un * nn_)
    return infonce_loss(pos_scores, neg_scores, neg_valid, 1.0, pair_mask)


def _query(news_emb: torch.Tensor, query_emb: Optional[torch.Tensor]) -> torch.Tensor:
    return news_emb if query_emb is None else query_emb


def flat_margin_loss(tower, news_emb, batch, margin: float, query_emb=None) -> torch.Tensor:
    """The margin-ranking loss of one flat batch (graph kept for backward)."""
    tok_idx, tok_rows, lens, *pairs = batch
    user = flat_user_vectors(tower, _query(news_emb, query_emb), tok_idx, tok_rows, lens, tower.output_normalize)
    return _pair_margin_loss(user, news_emb, *pairs, margin)


def flat_infonce_loss(tower, news_emb, batch, query_emb=None) -> torch.Tensor:
    """InfoNCE of one flat batch at temperature 1, as the JAX package's
    flat step takes it (graph kept for backward)."""
    tok_idx, tok_rows, lens, *pairs = batch
    user = flat_user_vectors(tower, _query(news_emb, query_emb), tok_idx, tok_rows, lens, tower.output_normalize)
    return _pair_infonce_loss(user, news_emb, *pairs)


def padded_margin_loss(tower, news_emb, batch, margin: float, generator=None, query_emb=None) -> torch.Tensor:
    """The margin-ranking loss of one padded batch (graph kept)."""
    hist_idx, hist_mask, *pairs = batch
    user = padded_user_vectors(tower, _query(news_emb, query_emb), hist_idx, hist_mask, generator)
    return _pair_margin_loss(user, news_emb, *pairs, margin)


def padded_infonce_loss(tower, news_emb, batch, generator=None, query_emb=None) -> torch.Tensor:
    """InfoNCE of one padded batch at temperature 1 (graph kept)."""
    hist_idx, hist_mask, *pairs = batch
    user = padded_user_vectors(tower, _query(news_emb, query_emb), hist_idx, hist_mask, generator)
    return _pair_infonce_loss(user, news_emb, *pairs)


def joint_margin_loss(
    tower, news_emb, batch, margin: float, blend=None, reduce=None, generator=None, query_emb=None
) -> torch.Tensor:
    """The margin loss of the tower trained jointly with ``reduce`` (a
    projector applied to the history rows and to both candidates before the
    tower and the cosine) and/or ``blend`` (a ``WeightedSumModel`` blending
    each cosine with the candidate's content baseline). ``batch`` is a
    padded batch followed by the baselines of the positives and the
    negatives [B]. The histories are read from ``query_emb`` (default
    ``news_emb``), the candidates from ``news_emb``."""
    hist_idx, hist_mask, hist_rev, pos_idx, neg_idx, pair_mask, baseline_pos, baseline_neg = batch
    user = padded_user_vectors(tower, _query(news_emb, query_emb), hist_idx, hist_mask, generator, reduce)
    u = gather_rows(user, hist_rev)
    cand_p, cand_n = news_emb[pos_idx.long()], news_emb[neg_idx.long()]
    if reduce is not None:
        cand_p, cand_n = reduce(cand_p), reduce(cand_n)
    cos_p, cos_n = safe_cosine(u, cand_p), safe_cosine(u, cand_n)
    if blend is not None:
        cos_p, cos_n = blend(cos_p, baseline_pos), blend(cos_n, baseline_neg)
    return margin_ranking_loss(cos_p, cos_n, margin, pair_mask)


def classification_margin_loss(head, news_emb, batch, margin: float) -> torch.Tensor:
    """The content scorer's margin loss: ``batch`` is ``(pos_idx [B],
    neg_idx [B], pair_mask [B])``, each side scored by the head alone."""
    pos_idx, neg_idx, pair_mask = batch
    pos_scores = head(news_emb[pos_idx.long()])[:, 0]
    neg_scores = head(news_emb[neg_idx.long()])[:, 0]
    return margin_ranking_loss(pos_scores, neg_scores, margin, pair_mask)


def classification_infonce_loss(head, news_emb, batch) -> torch.Tensor:
    """The content scorer's InfoNCE: the positive's head score against the
    K negatives' (``neg_idx`` [B, K], -1 pads masked), temperature 1."""
    pos_idx, neg_idx, pair_mask = batch
    neg_idx = neg_idx.long()
    b, k = neg_idx.shape
    pos_scores = head(news_emb[pos_idx.long()])[:, 0]
    neg_scores = head(news_emb[neg_idx.clamp_min(0).reshape(-1)])[:, 0].reshape(b, k)
    return infonce_loss(pos_scores, neg_scores, (neg_idx >= 0).float(), 1.0, pair_mask)


def e2e_news_and_user(
    token_encoder, tower, token_states, token_mask, hist_idx, hist_mask, generator=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The end-to-end forward: the token encoder over the batch's M distinct
    news ([M, T, D] states, [M, T] mask) -> ``news_vecs`` [M, D]; the tower
    over the histories gathered from them ([U, L] indices into M, masked);
    returns ``news_vecs`` and the user vectors [U, D]. Dropout, where the
    modules have it, draws from ``generator`` (the encoder's masks first,
    then the tower's)."""
    news_vecs = token_encoder(token_states, token_mask, generator=generator)
    gathered = gather_rows(news_vecs, hist_idx) * hist_mask[..., None].to(news_vecs.dtype)
    user = tower(gathered, hist_mask, generator=generator)
    return news_vecs, user


def e2e_margin_loss(token_encoder, tower, batch, margin: float, generator=None) -> torch.Tensor:
    """The margin loss of one streamed end-to-end batch ``(token_states,
    token_mask, hist_idx, hist_mask, hist_rev, pos_idx, neg_idx, pair_mask)``,
    every index addressing the batch's M news (graph kept for backward)."""
    news_vecs, user = e2e_news_and_user(token_encoder, tower, *batch[:4], generator)
    return _pair_margin_loss(user, news_vecs, *batch[4:], margin)


def e2e_infonce_loss(token_encoder, tower, batch, generator=None) -> torch.Tensor:
    """InfoNCE of one streamed end-to-end batch (``neg_idx`` [B, K], -1 pads)
    at temperature 1 (graph kept for backward)."""
    news_vecs, user = e2e_news_and_user(token_encoder, tower, *batch[:4], generator)
    return _pair_infonce_loss(user, news_vecs, *batch[4:])


def _gathered(flat_states, batch) -> tuple:
    return (gathered_token_states(flat_states, batch[0], batch[1]), *batch[1:])


def e2e_margin_loss_gathered(token_encoder, tower, flat_states, batch, margin: float, generator=None) -> torch.Tensor:
    """``e2e_margin_loss`` with the store resident on the card: ``batch``
    starts with the [M, T] indices into ``flat_states``'s rows and their
    mask (``TokenStore.padded_index_batch``), and the [M, T, D] block is
    gathered there; no gradient reaches the states."""
    return e2e_margin_loss(token_encoder, tower, _gathered(flat_states, batch), margin, generator)


def e2e_infonce_loss_gathered(token_encoder, tower, flat_states, batch, generator=None) -> torch.Tensor:
    """``e2e_infonce_loss`` with the store resident on the card."""
    return e2e_infonce_loss(token_encoder, tower, _gathered(flat_states, batch), generator)


def apply_step(optimizer, loss: torch.Tensor) -> torch.Tensor:
    """Backward of ``loss``, one optimizer step, gradients cleared; returns
    the loss (a tensor on the device: reading it waits for the card)."""
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def flat_margin_step(tower, optimizer, news_emb, batch, margin: float, query_emb=None) -> torch.Tensor:
    """One optimizer step on the margin loss of a flat ``batch``."""
    return apply_step(optimizer, flat_margin_loss(tower, news_emb, batch, margin, query_emb))


def flat_infonce_step(tower, optimizer, news_emb, batch, query_emb=None) -> torch.Tensor:
    """One optimizer step on the InfoNCE loss of a flat ``batch``."""
    return apply_step(optimizer, flat_infonce_loss(tower, news_emb, batch, query_emb))
