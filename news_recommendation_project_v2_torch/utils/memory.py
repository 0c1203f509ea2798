"""Analytic batch sizing: batch caps and chunk sizes come from arithmetic on
the shapes against the device's memory, not from probing for out-of-memory."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import EncoderConfig, TowerConfig

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
    output and its permuted copy). The GEGLU's scratch
    (``geglu_scratch_bytes``) comes on top. PERF.md gives the measured peak
    beside this model."""
    b = _DTYPE_BYTES.get(config.compute_dtype, 4)
    if config.kind != "latent":
        raise ValueError("flat scoring applies to token-local towers only")
    d = config.reduced_dim
    inner = config.num_heads * config.latent_dim_head
    widest = max(8 * d, 2 * inner)
    return (widest + 4 * d + config.num_heads * config.num_latents) * b


def geglu_scratch_bytes(config: TowerConfig) -> int:
    """Device scratch of one call of the latent tower's GEGLU (``ops.geglu``,
    F = 4·D), on top of the activations and freed after the call: the row
    chunks' u and pass B's partials, at most 64 MB
    (``ops.geglu.SCRATCH_LIMIT``); in float32, whose calls of 192 rows and
    more take the warpgroup route, also both weights split into their big
    and small TF32 halves, 2 × 3·D·F floats (96 MiB at D = 1,024, 1.5 GiB at
    D = 4,096)."""
    d = config.reduced_dim
    split = 2 * 3 * d * (4 * d) * 4 if config.compute_dtype == "float32" else 0
    return 64 * 2**20 + split


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


def estimate_head_batch(
    in_dim: int,
    hidden_dim: int = 4096,
    train: bool = False,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """The content scorer's (``ClassificationHead``) batch: a row costs its
    MLP widths, ``in_dim + 2 * hidden_dim`` float32 values, times
    ``TRAIN_MULTIPLIER`` for a train step; a multiple of 8 in ``fraction``
    of the device's memory (16 GiB on the CPU)."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_row = (in_dim + 2 * hidden_dim) * 4 * (TRAIN_MULTIPLIER if train else 1)
    return _floor_multiple(budget // max(per_row, 1), 8)


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


def transformer_activation_bytes(
    hidden_dim: int,
    num_heads: int,
    intermediate_dim: int,
    batch: int,
    length: int,
    bytes_per_el: int = 4,
) -> int:
    """Activation envelope of one encoder block over [batch, length] tokens:
    per token the packed QKV (3·H), the MLP's input and output (2·I) and the
    residual stream in and out (3·H), plus the attention probabilities
    (heads x L x L per row). One layer's worth: the layers run one after
    another."""
    tokens = batch * length
    per_token = 3 * hidden_dim + 2 * intermediate_dim + 3 * hidden_dim
    probs = batch * num_heads * length * length
    return (tokens * per_token + probs) * bytes_per_el


def encoder_activation_bytes(
    config: EncoderConfig, batch: int, length: Optional[int] = None, bytes_per_el: Optional[int] = None
) -> int:
    """The news encoder's activation envelope over [batch, length] tokens
    (``length`` defaults to ``config.max_length``): one block of its widths
    (``transformer_activation_bytes``, or ``deepseek_block_bytes`` for the
    DeepSeek-V3 layout) at ``compute_dtype``'s element size unless
    ``bytes_per_el`` is given; what stays float32 in any compute type
    (``encoder_float32_bytes``); and NV-Embed's latent-pool head
    (``latent_pool_bytes``), which runs after the last block. Kimi Linear's
    block is ``kimi_linear_block_bytes``, beside the float32 norm copies and
    the pooled states (3·D floats a token): its attention holds no [T, T]
    block."""
    if bytes_per_el is None:
        bytes_per_el = _DTYPE_BYTES.get(config.compute_dtype, 4)
    length = length or config.max_length
    if config.arch == "kimi_linear":
        block = kimi_linear_block_bytes(config, batch, length, bytes_per_el)
        return block + batch * length * 3 * config.hidden_dim * 4
    if config.arch == "deepseek_v3":
        block = deepseek_block_bytes(config, batch, length, bytes_per_el)
    else:
        block = transformer_activation_bytes(
            config.hidden_dim, config.num_heads, config.intermediate_dim, batch, length, bytes_per_el
        )
    return block + encoder_float32_bytes(config, batch, length) + latent_pool_bytes(config, batch, length, bytes_per_el)


def deepseek_block_bytes(config: EncoderConfig, batch: int, length: int, bytes_per_el: int) -> int:
    """One DeepSeek-V3 block over [batch, length] tokens, every token counted
    as real (the MoE routes the real ones only): the residual stream in and
    out (2·D) beside the largest of its three phases.

    - MLA, expanded: the normed input and the output projection (2·D), q
      and its concatenated copy (2 x heads·(nope + rope)), the latent and its
      rotary key before and after the norm (2·rank + rope), each head's key
      and value from the latent (heads·(nope + v)) and the concatenated key
      (heads·(nope + rope)), the rotary parts' de-interleaved and rotated
      copies (3 x heads·rope), the attention's output and its transpose
      (2 x heads·v); the attention's logits (heads x L x L a row, and their
      float32 softmax in ``encoder_float32_bytes``).
    - The dense layers' MLP: gate, up and their product (3 x intermediate).
    - The MoE, per token and its top-k pairs: the rows gathered in expert
      order (k·D), the gated h (k·I) and the weighted float32 expert outputs
      (k·D floats) live together at the down launch; the float32 combine and
      one gathered pair (2·D floats), the router's float32 scores and picks,
      and the shared experts' gate, up and product (3 x shared·I)."""
    b = bytes_per_el
    d, h, k = config.hidden_dim, config.num_heads, config.num_experts_per_tok
    nope, rope, v, rank = config.qk_nope_head_dim, config.qk_rope_head_dim, config.v_head_dim, config.kv_lora_rank
    mla = (2 * d + 2 * h * (nope + rope) + 2 * rank + rope + h * (nope + v) + h * (nope + rope) + 3 * h * rope
           + 2 * h * v) * b
    dense = 3 * config.intermediate_dim * b if config.first_k_dense_replace else 0
    i, e = config.moe_intermediate_size, config.n_routed_experts
    moe = (k * d + k * i) * b + k * d * 4 + 2 * d * 4 + 3 * e * 4 + 4 * k * 8 + 3 * config.n_shared_experts * i * b
    tokens = batch * length
    return tokens * (2 * d * b + max(mla, dense, moe)) + batch * h * length * length * b


def kimi_linear_block_bytes(config: EncoderConfig, batch: int, length: int, bytes_per_el: int) -> int:
    """One Kimi Linear block over [batch, length] tokens, every token counted
    as real: the residual stream in and out (2·D) beside the largest of its
    phases.

    - KDA (inner = heads x head_dim): q, k and v with a conv's padded copy
      and output beside them (6 x inner), log alpha with two float32
      temporaries (3 x inner floats), the recurrence's output and its float32
      norm and gate (4 x inner floats); and the state, heads x head_dim^2
      floats a row (2 MB at Kimi-Linear's widths; the kernel holds it in
      registers, the plain version in memory).
    - MLA as ``deepseek_block_bytes`` counts it, without the [T, T] logits
      (``scaled_dot_product_attention``), v padded to q's width (heads ·
      (nope + rope)).
    - The dense layer's MLP (3 x intermediate).
    - The MoE as ``deepseek_block_bytes`` counts it: with a share of the
      experts every pair is still gathered, and the rows past the held
      ones are allocated and left unread."""
    b = bytes_per_el
    d, h, k = config.hidden_dim, config.num_heads, config.num_experts_per_tok
    inner = config.kda_num_heads * config.kda_head_dim
    kda = 6 * inner * b + 3 * inner * 4 + 4 * inner * 4
    nope, rope, v, rank = config.qk_nope_head_dim, config.qk_rope_head_dim, config.v_head_dim, config.kv_lora_rank
    mla = (2 * d + 2 * h * (nope + rope) + 2 * rank + rope + h * (nope + v) + h * (nope + rope) + 2 * h * v
           + h * (nope + rope)) * b
    dense = 3 * config.intermediate_dim * b if config.first_k_dense_replace else 0
    i, e = config.moe_intermediate_size, config.n_routed_experts
    moe = (k * d + k * i) * b + k * d * 4 + 2 * d * 4 + 3 * e * 4 + 4 * k * 8 + 3 * config.n_shared_experts * i * b
    state = config.kda_num_heads * config.kda_head_dim**2 * 4
    return batch * length * (2 * d * b + max(kda, mla, dense, moe)) + batch * state


def encoder_float32_bytes(config: EncoderConfig, batch: int, length: int) -> int:
    """The encoder's float32 blocks, whatever its compute type: a norm's
    float32 copy of the residual stream and its product (2·D a token), the
    float32 hidden states handed to the pool (D), and the attention's
    masked logits and their softmax (twice heads x L x L a row). In 16 bits
    the block's model alone counts these at half their size."""
    tokens = batch * length
    return (tokens * 3 * config.hidden_dim + 2 * batch * config.num_heads * length * length) * 4


def latent_pool_bytes(config: EncoderConfig, batch: int, length: int, bytes_per_el: int) -> int:
    """NV-Embed's latent-pool head over [batch, length] tokens (0 without
    it), at ``bytes_per_el`` (its compute type): per token q and its
    permuted copy (2 x heads x dim_head; the attention's output and its copy
    after them), the GEGLU's [h | g] block (2 x 4·D) and its output (D), and
    the attention's probabilities over the latents (heads x latents, float32),
    plus the float32 LayerNorm and residual rows (2·D)."""
    if not config.latent_pool:
        return 0
    d = config.hidden_dim
    inner = config.latent_pool_heads * config.latent_pool_dim_head
    probs = config.latent_pool_heads * config.latent_pool_num_latents
    per_token = (2 * inner + 8 * d + d) * bytes_per_el + (2 * d + probs) * 4
    return batch * length * per_token


def estimate_encoder_batch(
    config: EncoderConfig,
    length: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """The news encoder's inference batch at ``length`` tokens: ``fraction``
    of the device's memory (16 GiB on the CPU) over
    ``encoder_activation_bytes`` of one row, a multiple of 8."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    return _floor_multiple(budget // max(encoder_activation_bytes(config, 1, length), 1), 8)


def estimate_token_attention_batch(
    dim: int,
    token_len: int,
    num_heads: int = 8,
    intermediate_dim: int = 3072,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """The learned token encoder's inference batch over stored token states
    (``ops.encode.materialize_from_token_store``): one float32 encoder block
    per news plus its gathered [token_len, dim] float32 input, in
    ``fraction`` of the device's memory, a multiple of 8."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_row = transformer_activation_bytes(dim, num_heads, intermediate_dim, 1, token_len) + token_len * dim * 4
    return _floor_multiple(budget // max(per_row, 1), 8)


def estimate_e2e_unique_news(
    dim: int,
    token_len: int,
    num_heads: int = 8,
    intermediate_dim: int = 3072,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.25,
    device: Optional[torch.device] = None,
) -> int:
    """End-to-end training capacity as the number M of distinct news a batch
    may hold (the axis that sets an ``EndToEndTrainer`` step's memory): per
    news the token encoder's forward and backward (``TRAIN_MULTIPLIER`` times
    its forward) and its [token_len, dim] float32 states."""
    budget = _budget(hbm_budget_bytes, fraction, device)
    per_news = (
        transformer_activation_bytes(dim, num_heads, intermediate_dim, 1, token_len) * TRAIN_MULTIPLIER
        + token_len * dim * 4
    )
    return _floor_multiple(budget // max(per_news, 1), 8)


def fits_device_token_store(
    total_tokens: int,
    dim: int,
    bytes_per_el: int = 4,
    hbm_budget_bytes: Optional[int] = None,
    fraction: float = 0.35,
    num_shards: int = 1,
    device: Optional[torch.device] = None,
) -> bool:
    """True when the whole flat token store [total_tokens, dim] fits in
    ``fraction`` of the device's memory beside the weights, the optimizer's
    state and a step's activations: ``EndToEndTrainer`` then keeps it on the
    card and gathers each batch's [M, T, D] block there, so a step uploads
    index grids instead of the block. A MIND-small title store (about 1.5 M
    tokens x 1024 float32, 6 GB) fits an 80 GB card; a 512-token full-text
    store (about 137 GB) streams from the host.

    ``num_shards`` budgets a store row-sharded over that many ranks
    (``parallel.sharding.shard_token_store_states``): each holds
    ``ceil(total_tokens / num_shards)`` rows, and the budget stays one
    device's."""
    per_device = -(-total_tokens // max(num_shards, 1)) * dim * bytes_per_el
    return per_device <= _budget(hbm_budget_bytes, fraction, device)
