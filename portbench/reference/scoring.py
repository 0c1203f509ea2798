"""Users and candidate scores of many rows in plain PyTorch, in blocks of
rows, so that a whole split fits beside nothing else on the card."""

from __future__ import annotations

import numpy as np
import torch

from .common import Precision, cosine


@torch.no_grad()
def user_vectors(
    tower_mod, params: dict, tower: dict, table: torch.Tensor, hist_rev, hist_lens, cap: int, prec: Precision,
    block_tokens: int = 1 << 16,
) -> torch.Tensor:
    """[rows, D] user vectors: each row's most recent ``cap`` clicks."""
    hist_lens = np.asarray(hist_lens, np.int64)
    ends = np.cumsum(hist_lens)
    lens = np.minimum(hist_lens, cap)
    dev = table.device
    out = torch.empty(len(lens), table.shape[1], device=dev)
    start = 0
    while start < len(lens):
        stop = start + max(1, int(np.searchsorted(np.cumsum(lens[start:]), block_tokens, side="right")))
        stop = min(stop, len(lens))
        ln = lens[start:stop]
        first = np.repeat(ends[start:stop] - ln, ln) + (np.arange(ln.sum()) - np.repeat(np.cumsum(ln) - ln, ln))
        idx = torch.as_tensor(np.asarray(hist_rev)[first], device=dev).long()
        lens_t = torch.as_tensor(ln, device=dev)
        if getattr(tower_mod, "TOKEN_LOCAL", False):
            out[start:stop] = tower_mod.users_flat(params, tower, table[idx], lens_t, prec)
        else:
            width = int(ln.max())
            pos = torch.arange(width, device=dev)
            mask = (pos[None, :] < lens_t[:, None]).float()
            x = torch.zeros(len(ln), width, table.shape[1], device=dev)
            x[mask.bool()] = table[idx]
            out[start:stop] = tower_mod.users_padded(params, tower, x, mask, prec)
        start = stop
    return out


@torch.no_grad()
def slot_scores(users: torch.Tensor, table: torch.Tensor, imp_rev, imp_lens, block: int = 1 << 18) -> np.ndarray:
    """The cosine of every candidate slot's news with its row's user."""
    rows = np.repeat(np.arange(len(imp_lens)), imp_lens)
    out = np.empty(len(rows), np.float64)
    dev = table.device
    for s in range(0, len(rows), block):
        r = torch.as_tensor(rows[s : s + block], device=dev)
        c = torch.as_tensor(np.asarray(imp_rev)[s : s + block], device=dev).long()
        out[s : s + block] = cosine(users[r], table[c]).double().cpu().numpy()
    return out
