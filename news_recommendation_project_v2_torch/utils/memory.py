"""Analytic batch sizing: batch caps and chunk sizes come from arithmetic on
the shapes against the device's memory, not from probing for out-of-memory."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import TowerConfig

# The budget when the device reports none (the CPU): 16 GiB, as in the JAX
# package.
DEFAULT_BUDGET_BYTES = 16 * 1024**3

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}

# A train step holds the forward's activations for the backward and the
# gradients: about 3x the forward's envelope, as in the JAX package.
TRAIN_MULTIPLIER = 3


def _budget(
    hbm_budget_bytes: Optional[int], fraction: float, device: Optional[torch.device]
) -> int:
    if hbm_budget_bytes is None:
        if device is not None and torch.device(device).type == "cuda":
            hbm_budget_bytes = torch.cuda.get_device_properties(device).total_memory
        else:
            hbm_budget_bytes = DEFAULT_BUDGET_BYTES
    return int(hbm_budget_bytes * fraction)


def _floor_multiple(x: int, m: int) -> int:
    return max(m, (x // m) * m)


def _floor_pow2(x: int, lo: int = 1024) -> int:
    p = lo
    while p * 2 <= x:
        p *= 2
    return p


def tower_activation_bytes(config: TowerConfig, batch: int, length: int) -> int:
    """Activation envelope of one padded tower forward over [batch, length]
    histories, at ``compute_dtype``'s element size. Per history token: the
    widest intermediate (the latent tower's GEGLU input 8·D or its q and
    kv blocks; ``final_attention``'s two hidden-wide blocks; the
    transformer's gated MLP 2·3,072 plus its packed QKV) and four D-wide
    rows; plus the attention probabilities (the latent tower's per-token
    heads x latents, the transformer's 8 heads x L x L). The JAX package's
    model, whose element size is 4 bytes whatever the compute type."""
    b = _DTYPE_BYTES.get(config.compute_dtype, 4)
    d = config.reduced_dim
    tokens = batch * length
    if config.kind == "latent":
        inner = config.num_heads * config.latent_dim_head
        widest = max(8 * d, 2 * inner)
        probs = batch * config.num_heads * length * config.num_latents
    elif config.kind == "final_attention":
        widest = 2 * config.hidden_dim
        probs = 0
    else:  # transformer
        widest = 2 * 3072 + 3 * d
        probs = batch * 8 * length * length
    return (tokens * (widest + 4 * d) + probs) * b


def estimate_tower_batch(
    config: TowerConfig,
    length: int,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """The largest multiple-of-8 batch of ``length``-token histories whose
    padded forward (``tower_activation_bytes``) fits in ``fraction`` of the
    device's memory (16 GiB on the CPU): the padded eval's batch."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    return _floor_multiple(budget // max(tower_activation_bytes(config, 1, length), 1), 8)


def estimate_tower_train_batch(
    config: TowerConfig,
    length: int,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """The padded train step's batch: the forward's envelope times
    ``TRAIN_MULTIPLIER`` (the saved activations and the gradients)."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_row = tower_activation_bytes(config, 1, length) * TRAIN_MULTIPLIER
    return _floor_multiple(budget // max(per_row, 1), 8)


def flat_token_bytes(config: TowerConfig) -> int:
    """Per-token activation bytes of the flat scoring path
    (``ops.scoring.FlatEvalPlan``): the widest of the GEGLU input (8·D) and
    the q and attention-output blocks (2 × heads·dim_head), plus four D-wide
    rows and the attention's per-token probabilities, at ``compute_dtype``'s
    element size.

    The port holds less at once: the gathered row and its LayerNorm (2·D,
    the LayerNorm in float32 whatever the compute type) plus two
    heads·dim_head blocks (q and its permuted copy, or the attention's
    output and its permuted copy). The GEGLU's row-chunk scratch (at most
    64 MB, ``ops.geglu.SCRATCH_LIMIT``) comes on top. PERF.md gives the
    measured peak beside this model."""
    b = _DTYPE_BYTES.get(config.compute_dtype, 4)
    if config.kind != "latent":
        raise ValueError("flat scoring applies to token-local towers only")
    d = config.reduced_dim
    inner = config.num_heads * config.latent_dim_head
    widest = max(8 * d, 2 * inner)
    return (widest + 4 * d + config.num_heads * config.num_latents) * b


def estimate_flat_chunk(
    config: TowerConfig,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """Token-chunk size of the flat scoring path: ``fraction`` of the
    device's memory over ``flat_token_bytes``, floored to a power of two so
    chunk shapes are stable across datasets."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    return _floor_pow2(budget // max(flat_token_bytes(config), 1))


def estimate_metric_rows(
    max_len: int,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.125,
    device: Optional[torch.device] = None,
) -> int:
    """Row-chunk size of the on-device metric pass (``eval.device_metrics``):
    a row holds about sixteen [L]-wide float32 temporaries (the sort, the
    tie-group cumulatives, the gains), floored to a power of two."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    return _floor_pow2(budget // max(16 * 4 * max(max_len, 1), 1), lo=64)


def estimate_serve_batch_cap(
    dim: int,
    history_len: int,
    num_candidates: int,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.0625,
    tower_multiplier: int = 12,
    device: Optional[torch.device] = None,
) -> int:
    """Power-of-two request-batch cap for one ``serve.Ranker`` shape group
    ([B, L] histories x [B, C] candidates).

    ``Ranker`` takes a bare tower with no ``TowerConfig``, so the tower's
    internal widths are covered by a generic ``tower_multiplier`` on the
    gathered [L, D] input block (the latent tower's widest activations, the
    8x-dim GEGLU input plus the Q/KV blocks, are ~12x the input row). The
    budget is ``fraction`` of the device's memory (16 GiB on the CPU). Group
    sizes pad up to a power of two below the cap and larger groups chunk at
    it, which bounds pad waste.
    """
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_row = (history_len * dim * tower_multiplier + num_candidates * dim) * 4
    return _floor_pow2(max(budget // max(per_row, 1), 8), lo=8)
