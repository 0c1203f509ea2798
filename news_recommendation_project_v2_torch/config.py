"""Constants, the news-encoder and user-tower configurations and the training
settings (the port's own copy)."""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Optional


class NewsDataset(enum.Enum):
    """The MIND splits."""

    MINDsmall_train = "MINDsmall_train"
    MINDsmall_dev = "MINDsmall_dev"
    MINDlarge_train = "MINDlarge_train"
    MINDlarge_dev = "MINDlarge_dev"
    MINDlarge_test = "MINDlarge_test"


class DataSubset(enum.Enum):
    """Which behaviors rows a load keeps: those with a history, those
    without, or all."""

    WITH_HISTORY = "with_history"
    WITHOUT_HISTORY = "without_history"
    ALL = "all"


# The width of MIND's entity vectors (``entity_embedding.vec``).
ENTITY_EMBEDDING_DIM = 100

# The news encoder: intfloat/multilingual-e5-large-instruct, its token cap,
# and the e5 instruction prompts (query side; the classification prompt).
MODEL_PATH = "intfloat/multilingual-e5-large-instruct"
NEWS_TEXT_MAXLEN = 512
NEWS_CLASSIFICATION_PROMPT = (
    "Please analyze the following news article to inform if the user would read "
    "the following news article.\nThe news article is: "
)
QUERY_INSTRUCTION = (
    "Instruct: Given a news article that the user has read, retrieve news articles "
    "that the user would also read \nQuery: "
)

EMBEDDING_DIM = 1024
REDUCED_DIM = EMBEDDING_DIM
NUM_HIDDEN_LAYERS = 1  # transformer tower layers
IMPRESSION_MAXLEN = 600

# The default training seed, as in the JAX package.
DEFAULT_SEED = 1234

# Static shape buckets: ragged history / impression lengths pad up to the
# nearest bucket, so the serving path sees a small, fixed set of shapes.
HISTORY_BUCKETS: tuple[int, ...] = (16, 32, 64, 128, 256, IMPRESSION_MAXLEN)
IMPRESSION_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 300)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (lengths beyond the last bucket are truncated to it)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def bucket_for_open(length: int, buckets: tuple[int, ...]) -> int:
    """Like ``bucket_for``, but lengths past the last bucket round up to the
    next multiple of it: for axes that must never be truncated, such as an
    end-to-end batch's union of news."""
    for b in buckets:
        if length <= b:
            return b
    step = buckets[-1]
    return -(-length // step) * step


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The mesh of the multi-GPU presets (config[3..4]): the world's ranks
    (one process each, joined by ``torch.distributed``) as a ``(data,
    model)`` grid; ``data`` shards the batches, ``model`` the news table's
    rows. ``parallel.mesh.build_mesh`` builds it."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_size: int = -1  # -1: every device
    model_size: int = 1


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """User-tower architecture. The latent tower's cross-attention always runs
    through the CUDA kernel on the card (its plain version on the CPU), so the
    JAX package's ``fused_attention`` switch has no counterpart here."""

    kind: str = "latent"  # final_attention | transformer | latent
    embedding_dim: int = EMBEDDING_DIM
    reduced_dim: int = REDUCED_DIM
    hidden_dim: int = 4096
    num_heads: int = 8
    num_layers: int = NUM_HIDDEN_LAYERS
    num_latents: int = 64
    latent_dim_head: int = 512
    dropout_rate: float = 0.1
    as_built: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings: a global-norm clip, then AdamW (betas 0.9 and
    0.999, eps 1e-8, ``weight_decay`` on every parameter); the margin-2
    ranking loss or InfoNCE against ``num_neg_per_pos`` sampled negatives."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    grad_clip_norm: float = 0.5
    margin: float = 2.0
    num_epochs: int = 5
    batch_size: int = 512
    num_neg_per_pos: int = 5
    max_neg_ratio: Optional[float] = None
    max_pos_ratio: Optional[float] = None
    seed: int = DEFAULT_SEED
    loss: str = "margin"  # margin | infonce
    # ReduceLROnPlateau(patience): multiply the lr by ``plateau_factor`` after
    # ``plateau_patience`` epochs without val-metric improvement. 0 disables.
    plateau_patience: int = 0
    plateau_factor: float = 0.1
    # Fetch the step loss to the host every N steps (each fetch waits for the
    # card); every step's loss is still recorded.
    loss_sync_every: int = 1


def tower_kwargs_for_dim(dim: Optional[int]) -> dict:
    """The CLI's ``--dim`` -> TowerConfig overrides, so a checkpoint trained
    at ``--dim X`` restores everywhere."""
    if not dim:
        return {}
    return dict(
        embedding_dim=dim,
        reduced_dim=dim,
        hidden_dim=4 * dim,
        num_latents=min(64, dim),
        latent_dim_head=max(8, dim // 2),
    )


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """The news text encoder. Defaults: e5-large (a 24-layer XLM-R-large),
    mean pooling, L2-normalised, float32 parameters computing in bfloat16.

    ``arch="bert"`` is the post-norm BERT/XLM-R layout; ``arch="qwen2"`` the
    decoder layout of Qwen2, Mistral and Llama (rotary positions, RMSNorm,
    grouped-query attention, SiLU-gated MLP, a causal mask), q/k/v biased by
    ``qkv_bias``. NV-Embed's wrapper is two switches over that layout:
    ``bidirectional`` drops the causal half of the mask, and ``latent_pool``
    pools with the latent-attention tower (``latent_pool_num_latents``
    latents, ``latent_pool_heads`` heads of ``latent_pool_dim_head``) instead
    of ``pooling``.

    ``arch="deepseek_v3"`` is DeepSeek-V3's decoder (Moonlight): multi-head
    latent attention (``q_proj`` to ``qk_nope_head_dim + qk_rope_head_dim``
    a head; keys and values through a ``kv_lora_rank`` latent and one shared
    rotary key of ``qk_rope_head_dim``; values of ``v_head_dim``), the first
    ``first_k_dense_replace`` layers with a dense SiLU-gated MLP of
    ``intermediate_dim`` and the rest a mixture of ``n_routed_experts``
    experts of ``moe_intermediate_size``, ``num_experts_per_tok`` a token
    (``scoring_func`` sigmoid, ``topk_method`` noaux_tc: picked on the score
    plus a per-expert bias, weighted by the score, renormalised by
    ``norm_topk_prob`` and scaled by ``routed_scaling_factor``) beside
    ``n_shared_experts`` shared experts over every token.

    ``arch="kimi_linear"`` is Kimi Linear's hybrid decoder: each layer's
    token mixer is ``layer_kinds[i]``, ``"kda"`` (Kimi Delta Attention,
    ``kda_num_heads`` heads of ``kda_head_dim``, short convs of
    ``short_conv_kernel_size``) or ``"mla"`` (DeepSeek-V3's latent attention,
    without rotation where ``mla_use_nope``), and its MLP that of the
    ``deepseek_v3`` layout. ``experts_held`` ``(first, count)`` is this
    device's share of an expert-parallel deployment: the router scores all
    ``n_routed_experts`` and keeps the pairs of experts ``first`` to
    ``first + count - 1``, whose weights alone are held (``None``: all)."""

    vocab_size: int = 250002
    hidden_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_dim: int = 4096
    max_position: int = 514
    layer_norm_eps: float = 1e-5
    pooling: str = "mean"  # mean | first | last
    normalize: bool = True
    max_length: int = NEWS_TEXT_MAXLEN
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    arch: str = "bert"  # bert | qwen2 | deepseek_v3 | kimi_linear
    num_kv_heads: Optional[int] = None  # None: num_heads
    head_dim: Optional[int] = None  # None: hidden_dim // num_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = True
    bidirectional: bool = False
    latent_pool: bool = False
    latent_pool_num_latents: int = 512
    latent_pool_heads: int = 8
    latent_pool_dim_head: int = 4096
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    layer_kinds: tuple[str, ...] = ()
    kda_num_heads: int = 0
    kda_head_dim: int = 0
    short_conv_kernel_size: int = 4
    mla_use_nope: bool = False
    experts_held: Optional[tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment: the data, the tower, the training and the mesh."""

    name: str = "e5_query_latent_attention"
    data_dir: Path = Path("data")
    dataset_train: NewsDataset = NewsDataset.MINDsmall_train
    dataset_dev: NewsDataset = NewsDataset.MINDsmall_dev
    data_subset: DataSubset = DataSubset.ALL
    tower: TowerConfig = dataclasses.field(default_factory=TowerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    log_dir: Path = Path("logs")
    ckpt_dir: Path = Path("models")
