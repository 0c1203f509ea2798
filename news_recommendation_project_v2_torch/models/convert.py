"""JAX/flax parameters -> the port's ``state_dict``s, and random parameters
in the JAX layout.

Each ``*_state_dict_from_jax`` is the inverse of one of the JAX package's
converters (``models/convert_towers.py``): a flax ``Dense.kernel`` is
[in, out] and a torch ``Linear.weight`` [out, in], so kernels transpose; a
flax ``LayerNorm.scale`` is a torch ``weight``; an ``Embed.embedding`` is an
``Embedding.weight``. Arrays arrive as numpy (or anything ``np.asarray``
reads) and leave as float32 tensors; ``load_state_dict`` casts them to the
module's parameter type. Params may come with or without the outer
``{"params": ...}``.

The ``random_*_params`` generators draw every weight from one numpy
generator, so one seed gives both packages the same weights: flax kernels
[in, out] at LeCun-normal scale, LayerNorm scales and all biases perturbed so
that they matter.

The end-to-end model (config[2]) is a ``ModuleDict`` of ``token_encoder``
(a ``TokenAttentionPool``) and ``tower`` (the latent tower), the JAX
package's ``{"token_encoder": ..., "tower": ...}`` params:
``e2e_state_dict_from_jax`` maps those to its ``state_dict`` and
``e2e_params_from_state_dict`` maps a ``state_dict`` back (the port's copy of
the JAX package's ``convert_token_attention_pool`` and
``convert_latent_attention``).

The news encoder's ``state_dict`` uses HF's names: ``encoder_state_dict_from_jax``
is the inverse of the JAX package's ``convert_hf_state_dict``, and
``encoder_state_dict_from_hf`` readies an HF checkpoint for
``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..config import EncoderConfig, TowerConfig
from .attention import INTERMEDIATE_SIZE

StateDict = dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params.get("params", params)


def _put_dense(sd: StateDict, prefix: str, dense: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        sd[f"{prefix}.bias"] = _t(dense["bias"])


def _put_ln(sd: StateDict, prefix: str, ln: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(ln["scale"])
    sd[f"{prefix}.bias"] = _t(ln["bias"])


def _with_prefix(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


# -- random parameters in the JAX layout ---------------------------------------


class _Draw:
    """Weight shapes from one numpy generator."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def normal(self, *shape, scale=1.0) -> np.ndarray:
        return self.rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def dense(self, i: int, o: int, bias: bool = True) -> dict:
        p = {"kernel": self.normal(i, o, scale=i**-0.5)}
        if bias:
            p["bias"] = self.normal(o, scale=0.02)
        return p

    def ln(self, d: int) -> dict:
        return {"scale": 1.0 + self.normal(d, scale=0.1), "bias": self.normal(d, scale=0.1)}


def random_latent_params(rng: np.random.Generator, cfg: TowerConfig) -> dict:
    """A latent tower of ``cfg``'s widths."""
    w = _Draw(rng)
    d, inner = cfg.reduced_dim, cfg.num_heads * cfg.latent_dim_head
    return {
        "params": {
            "latents": w.normal(cfg.num_latents, d),
            "cross_prenorm": w.ln(d),
            "cross_prenorm_context": w.ln(d),
            "cross_attn": {
                "to_q": w.dense(d, inner, bias=False),
                "to_kv": w.dense(d, 2 * inner, bias=False),
                "to_out": w.dense(inner, d, bias=False),
            },
            "ff_prenorm": w.ln(d),
            "cross_ff": {"proj_in": w.dense(d, 8 * d), "proj_out": w.dense(4 * d, d)},
        }
    }


def random_final_attention_params(rng: np.random.Generator, cfg: TowerConfig) -> dict:
    """A ``FinalAttention`` of ``cfg``'s ``reduced_dim`` and ``hidden_dim``."""
    w = _Draw(rng)
    d, h = cfg.reduced_dim, cfg.hidden_dim
    return {
        "params": {
            "linear1": w.dense(d, h),
            "linear2": w.dense(h, h),
            "linear3": w.dense(h, d),
            "linear4": w.dense(d, h),
            "linear5": w.dense(h, d, bias=False),
        }
    }


def _random_encoder(w: _Draw, d: int, num_layers: int) -> dict:
    return {
        f"layer_{i}": {
            "attention": {"qkv_proj": w.dense(d, 3 * d), "o_proj": w.dense(d, d)},
            "g_mlp": {
                "up_gate_proj": w.dense(d, 2 * INTERMEDIATE_SIZE, bias=False),
                "down_proj": w.dense(INTERMEDIATE_SIZE, d),
            },
            "attn_layernorm": w.ln(d),
            "g_mlp_layernorm": w.ln(d),
        }
        for i in range(num_layers)
    }


def random_transformer_params(rng: np.random.Generator, cfg: TowerConfig) -> dict:
    """A ``TransformerTower`` of ``cfg``'s ``reduced_dim`` and ``num_layers``."""
    w = _Draw(rng)
    d = cfg.reduced_dim
    return {"params": {"encoder": _random_encoder(w, d, cfg.num_layers), "linear1": w.dense(d, d)}}


def random_token_attention_pool_params(rng: np.random.Generator, hidden_size: int, num_layers: int) -> dict:
    """A ``TokenAttentionPool`` (its encoder; the pool has no parameters)."""
    return {"params": {"encoder": _random_encoder(_Draw(rng), hidden_size, num_layers)}}


def random_classification_head_params(
    rng: np.random.Generator, in_dim: int, hidden_dim: int, out_dim: int = 1
) -> dict:
    w = _Draw(rng)
    return {
        "params": {
            "linear_1": w.dense(in_dim, hidden_dim),
            "linear_2": w.dense(hidden_dim, hidden_dim),
            "linear_3": w.dense(hidden_dim, out_dim),
        }
    }


def random_weighted_sum_params(rng: np.random.Generator) -> dict:
    """A ``WeightedSumModel``: ``alpha`` drawn away from its zero init."""
    return {"params": {"alpha": _Draw(rng).normal(scale=0.5)}}


def random_reducing_params(rng: np.random.Generator, input_dim: int, output_dim: int) -> dict:
    w = _Draw(rng)
    return {"params": {"linear": w.dense(input_dim, output_dim), "linear2": w.dense(output_dim, output_dim)}}


RANDOM_TOWER_PARAMS = {
    "final_attention": random_final_attention_params,
    "transformer": random_transformer_params,
    "latent": random_latent_params,
}


def random_tower_params(rng: np.random.Generator, cfg: TowerConfig) -> dict:
    """Random parameters of the user tower of ``cfg.kind``."""
    return RANDOM_TOWER_PARAMS[cfg.kind](rng, cfg)


# -- flax params -> port state_dicts -------------------------------------------


def latent_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_latent_attention``'s inverse (``LatentAttentionTower``)."""
    p = _params(params)
    attn, ff = "cross_attend_blocks.0", "cross_attend_blocks.1"
    sd = {"latents": _t(p["latents"])}
    _put_ln(sd, f"{attn}.norm", p["cross_prenorm"])
    _put_ln(sd, f"{attn}.norm_context", p["cross_prenorm_context"])
    _put_ln(sd, f"{ff}.norm", p["ff_prenorm"])
    for name in ("to_q", "to_kv", "to_out"):
        _put_dense(sd, f"{attn}.fn.{name}", p["cross_attn"][name])
    _put_dense(sd, f"{ff}.fn.net.0", p["cross_ff"]["proj_in"])
    _put_dense(sd, f"{ff}.fn.net.2", p["cross_ff"]["proj_out"])
    return sd


def _dense_layers(p: Mapping[str, Any], names) -> StateDict:
    sd: StateDict = {}
    for name in names:
        _put_dense(sd, name, p[name])
    return sd


def final_attention_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_final_attention``'s inverse (``FinalAttention``)."""
    return _dense_layers(_params(params), ("linear1", "linear2", "linear3", "linear4", "linear5"))


def _encoder_state_dict(encoder: Mapping[str, Any]) -> StateDict:
    """A ``TransformerEncoder``'s layers ``layer_{i}`` -> ``layer.{i}.*``."""
    sd: StateDict = {}
    for i in range(len(encoder)):
        layer, prefix = encoder[f"layer_{i}"], f"layer.{i}"
        for block, name in (("attention", "qkv_proj"), ("attention", "o_proj"), ("g_mlp", "up_gate_proj"), ("g_mlp", "down_proj")):
            _put_dense(sd, f"{prefix}.{block}.{name}", layer[block][name])
        _put_ln(sd, f"{prefix}.attn_layernorm", layer["attn_layernorm"])
        _put_ln(sd, f"{prefix}.g_mlp_layernorm", layer["g_mlp_layernorm"])
    return sd


def transformer_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_transformer_tower``'s inverse (``TransformerTower``; the
    number of layers is read from the params)."""
    p = _params(params)
    sd = _with_prefix("encoder.", _encoder_state_dict(p["encoder"]))
    _put_dense(sd, "linear1", p["linear1"])
    return sd


def token_attention_pool_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_token_attention_pool``'s inverse (``TokenAttentionPool``)."""
    return _with_prefix("encoder.", _encoder_state_dict(_params(params)["encoder"]))


def classification_head_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_classification_head``'s inverse (``ClassificationHead``)."""
    return _dense_layers(_params(params), ("linear_1", "linear_2", "linear_3"))


def classification_head_cat_embed_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_classification_head_cat_embed``'s inverse."""
    p = _params(params)
    sd = _dense_layers(p, ("linear_1", "linear_2", "linear_3"))
    sd["cat_embed.weight"] = _t(p["cat_embed"]["embedding"])
    return sd


def weighted_sum_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_weighted_sum``'s inverse (``WeightedSumModel``)."""
    return {"alpha": _t(_params(params)["alpha"])}


def reducing_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``convert_reducing_model``'s inverse (``ReducingModel``)."""
    return _dense_layers(_params(params), ("linear", "linear2"))


def embedding_wrapper_state_dict_from_jax(
    params: Mapping[str, Any], wrapped: Callable[[Mapping[str, Any]], StateDict]
) -> StateDict:
    """``convert_embedding_wrapper``'s inverse; ``wrapped`` converts the inner
    tower's params."""
    p = _params(params)
    sd = _with_prefix("wrapped_model.", wrapped(p["wrapped"]))
    sd["cat_embed.weight"] = _t(p["cat_embed"]["embedding"])
    sd["subcat_embed.weight"] = _t(p["subcat_embed"]["embedding"])
    return sd


def resize_wrapper_state_dict_from_jax(
    params: Mapping[str, Any], wrapped: Callable[[Mapping[str, Any]], StateDict]
) -> StateDict:
    """``convert_resize_wrapper``'s inverse; ``wrapped`` converts the inner
    tower's params."""
    p = _params(params)
    sd = _with_prefix("wrapped_model.", wrapped(p["wrapped"]))
    sd.update(_dense_layers(p, ("bottleneck_in", "bottleneck_out")))
    return sd


STATE_DICT_FROM_JAX = {
    "final_attention": final_attention_state_dict_from_jax,
    "transformer": transformer_state_dict_from_jax,
    "latent": latent_state_dict_from_jax,
}


def tower_state_dict_from_jax(kind: str, params: Mapping[str, Any]) -> StateDict:
    """The user tower of ``kind``'s flax params -> its port ``state_dict``."""
    return STATE_DICT_FROM_JAX[kind](params)


# -- the end-to-end model (config[2]) ------------------------------------------


def random_e2e_params(rng: np.random.Generator, dim: int, num_layers: int, tower_cfg: TowerConfig) -> dict:
    """``{"token_encoder": ..., "tower": ...}``: a ``TokenAttentionPool`` of
    ``num_layers`` at ``dim``, then a latent tower of ``tower_cfg``."""
    return {
        "token_encoder": random_token_attention_pool_params(rng, dim, num_layers),
        "tower": random_latent_params(rng, tower_cfg),
    }


def e2e_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """The JAX package's end-to-end params -> the ``state_dict`` of
    ``ModuleDict(token_encoder=TokenAttentionPool, tower=LatentAttentionTower)``."""
    return {
        **_with_prefix("token_encoder.", token_attention_pool_state_dict_from_jax(params["token_encoder"])),
        **_with_prefix("tower.", latent_state_dict_from_jax(params["tower"])),
    }


def _np(sd: Mapping[str, Any], key: str) -> np.ndarray:
    v = sd[key]
    return v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _get_dense(sd, prefix: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd, f"{prefix}.weight").T}
    if bias:
        out["bias"] = _np(sd, f"{prefix}.bias")
    return out


def _get_ln(sd, prefix: str) -> dict:
    return {"scale": _np(sd, f"{prefix}.weight"), "bias": _np(sd, f"{prefix}.bias")}


def e2e_params_from_state_dict(sd: Mapping[str, Any]) -> dict:
    """``e2e_state_dict_from_jax``'s inverse: the end-to-end ``state_dict``
    -> ``{"token_encoder": {"params": ...}, "tower": {"params": ...}}`` as
    numpy arrays in the flax layout."""
    encoder, layers = {}, sorted({int(k.split(".")[3]) for k in sd if k.startswith("token_encoder.encoder.layer.")})
    for i in layers:
        p = f"token_encoder.encoder.layer.{i}"
        encoder[f"layer_{i}"] = {
            "attention": {"qkv_proj": _get_dense(sd, f"{p}.attention.qkv_proj"), "o_proj": _get_dense(sd, f"{p}.attention.o_proj")},
            "g_mlp": {
                "up_gate_proj": _get_dense(sd, f"{p}.g_mlp.up_gate_proj", bias=False),
                "down_proj": _get_dense(sd, f"{p}.g_mlp.down_proj"),
            },
            "attn_layernorm": _get_ln(sd, f"{p}.attn_layernorm"),
            "g_mlp_layernorm": _get_ln(sd, f"{p}.g_mlp_layernorm"),
        }
    attn, ff = "tower.cross_attend_blocks.0", "tower.cross_attend_blocks.1"
    tower = {
        "latents": _np(sd, "tower.latents"),
        "cross_prenorm": _get_ln(sd, f"{attn}.norm"),
        "cross_prenorm_context": _get_ln(sd, f"{attn}.norm_context"),
        "cross_attn": {name: _get_dense(sd, f"{attn}.fn.{name}", bias=False) for name in ("to_q", "to_kv", "to_out")},
        "ff_prenorm": _get_ln(sd, f"{ff}.norm"),
        "cross_ff": {"proj_in": _get_dense(sd, f"{ff}.fn.net.0"), "proj_out": _get_dense(sd, f"{ff}.fn.net.2")},
    }
    return {"token_encoder": {"params": {"encoder": encoder}}, "tower": {"params": tower}}


# -- the news encoder ------------------------------------------------------------


def random_encoder_params(cfg: EncoderConfig, seed: int) -> dict:
    """A ``NewsEncoder`` of ``cfg``'s layout and widths in the JAX package's
    layout, from ``np.random.default_rng(seed)``: embeddings N(0, 1), the
    ``latent_pool`` head (if any) as ``random_latent_params`` draws it."""
    w = _Draw(np.random.default_rng(seed))
    d, f = cfg.hidden_dim, cfg.intermediate_dim
    p: dict[str, Any] = {"word_embeddings": {"embedding": w.normal(cfg.vocab_size, d)}}
    if cfg.arch == "qwen2":
        hd = cfg.head_dim or d // cfg.num_heads
        h, kv = cfg.num_heads, cfg.num_kv_heads or cfg.num_heads

        def rms():
            return {"scale": 1.0 + w.normal(d, scale=0.1)}

        for i in range(cfg.num_layers):
            p[f"layer_{i}"] = {
                "input_norm": rms(),
                "q_proj": w.dense(d, h * hd, bias=cfg.qkv_bias),
                "k_proj": w.dense(d, kv * hd, bias=cfg.qkv_bias),
                "v_proj": w.dense(d, kv * hd, bias=cfg.qkv_bias),
                "o_proj": w.dense(h * hd, d, bias=False),
                "post_attn_norm": rms(),
                "gate_proj": w.dense(d, f, bias=False),
                "up_proj": w.dense(d, f, bias=False),
                "down_proj": w.dense(f, d, bias=False),
            }
        p["final_norm"] = rms()
    else:
        p["position_embeddings"] = {"embedding": w.normal(cfg.max_position, d)}
        p["token_type_embeddings"] = {"embedding": w.normal(1, d)}
        p["embeddings_norm"] = w.ln(d)
        for i in range(cfg.num_layers):
            p[f"layer_{i}"] = {
                "q": w.dense(d, d), "k": w.dense(d, d), "v": w.dense(d, d),
                "attn_out": w.dense(d, d), "attn_norm": w.ln(d),
                "ffn_in": w.dense(d, f), "ffn_out": w.dense(f, d), "ffn_norm": w.ln(d),
            }
    if cfg.latent_pool:
        head = TowerConfig(
            reduced_dim=d, num_heads=cfg.latent_pool_heads, num_latents=cfg.latent_pool_num_latents,
            latent_dim_head=cfg.latent_pool_dim_head,
        )
        p["latent_pool"] = random_latent_params(w.rng, head)["params"]
    return {"params": p}


def encoder_state_dict_from_jax(params: Mapping[str, Any], cfg: EncoderConfig) -> StateDict:
    """The JAX package's ``NewsEncoder`` params -> the port's ``state_dict``
    (HF names; the head under ``latent_pool.``): the inverse of the JAX
    package's ``convert_hf_state_dict``."""
    p = _params(params)
    sd: StateDict = {}
    if cfg.arch == "qwen2":
        sd["embed_tokens.weight"] = _t(p["word_embeddings"]["embedding"])
        sd["norm.weight"] = _t(p["final_norm"]["scale"])
        names = {
            "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
            "o_proj": "self_attn.o_proj", "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
            "down_proj": "mlp.down_proj",
        }
        for i in range(cfg.num_layers):
            layer, prefix = p[f"layer_{i}"], f"layers.{i}"
            sd[f"{prefix}.input_layernorm.weight"] = _t(layer["input_norm"]["scale"])
            sd[f"{prefix}.post_attention_layernorm.weight"] = _t(layer["post_attn_norm"]["scale"])
            for ours, theirs in names.items():
                _put_dense(sd, f"{prefix}.{theirs}", layer[ours])
    else:
        for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
            sd[f"embeddings.{name}.weight"] = _t(p[name]["embedding"])
        _put_ln(sd, "embeddings.LayerNorm", p["embeddings_norm"])
        names = {
            "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
            "attn_out": "attention.output.dense", "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
        }
        for i in range(cfg.num_layers):
            layer, prefix = p[f"layer_{i}"], f"encoder.layer.{i}"
            for ours, theirs in names.items():
                _put_dense(sd, f"{prefix}.{theirs}", layer[ours])
            _put_ln(sd, f"{prefix}.attention.output.LayerNorm", layer["attn_norm"])
            _put_ln(sd, f"{prefix}.output.LayerNorm", layer["ffn_norm"])
    if cfg.latent_pool:
        sd.update(_with_prefix("latent_pool.", latent_state_dict_from_jax(p["latent_pool"])))
    return sd


def _strip(state: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix) :]: v for k, v in state.items() if k.startswith(prefix)}


def _stack_experts(state: dict, cfg: EncoderConfig) -> dict:
    """A DeepSeek-V3 checkpoint's per-expert tensors
    (``layers.{l}.mlp.experts.{e}.{gate,up,down}_proj.weight``) stacked into
    the ``MoEBlock``'s ``experts.gate_up_proj`` [E, 2I, D] (each expert's gate
    rows, then its up rows) and ``experts.down_proj`` [E, D, I]; raises on a
    layer that lacks an expert."""
    out = {k: v for k, v in state.items() if ".mlp.experts." not in k}
    for layer in range(cfg.first_k_dense_replace, cfg.num_layers):
        prefix = f"layers.{layer}.mlp.experts."
        names = [f"{prefix}{e}.{w}_proj.weight" for e in range(cfg.n_routed_experts) for w in ("gate", "up", "down")]
        missing = [n for n in names if n not in state]
        if len(missing) == len(names):
            continue  # no experts in the checkpoint: load_state_dict names what is missing
        if missing:
            raise ValueError(f"checkpoint lacks {len(missing)} expert tensors, the first {missing[0]}")
        gate_up, down = [], []
        for e in range(cfg.n_routed_experts):
            g, u, d = (torch.as_tensor(state[f"{prefix}{e}.{w}_proj.weight"]) for w in ("gate", "up", "down"))
            gate_up.append(torch.cat([g, u]))
            down.append(d)
        out[prefix + "gate_up_proj"] = torch.stack(gate_up)
        out[prefix + "down_proj"] = torch.stack(down)
    return out


def encoder_state_dict_from_hf(state: Mapping[str, Any], cfg: EncoderConfig) -> StateDict:
    """An HF checkpoint's state dict (``load_hf_weights``) -> the keys of
    ``NewsEncoder(cfg)``, for ``load_state_dict``: a task prefix stripped
    (``roberta.``, ``bert.`` or ``model.``); an NV-Embed checkpoint split
    into its backbone (``embedding_model.``) and its head
    (``latent_attention_model.`` -> ``latent_pool.``); a DeepSeek-V3
    checkpoint's experts stacked (``_stack_experts``); keys the encoder has
    no use for (a pooler, an ``lm_head``, position-id buffers) dropped.
    Raises, as the JAX package's converter does, when the checkpoint's
    NV-Embed head or its q/k/v biases disagree with ``cfg``; a missing
    tensor raises in ``load_state_dict``."""
    from .news_encoder import NewsEncoder

    state = dict(state)
    head = None
    if cfg.arch == "qwen2":
        if any(k.startswith("embedding_model.") for k in state):
            head = _strip(state, "latent_attention_model.")
            state = _strip(state, "embedding_model.")
        if head is not None or cfg.latent_pool:
            if not head:
                raise ValueError(
                    "EncoderConfig.latent_pool is set but the checkpoint has no "
                    "latent_attention_model.* tensors — is this really an "
                    "NV-Embed-layout checkpoint?"
                )
            if not cfg.latent_pool:
                raise ValueError(
                    "checkpoint carries an NV-Embed latent_attention_model head "
                    "but EncoderConfig.latent_pool is False; derive the config "
                    "with encoder_config_from_hf on the checkpoint's config.json "
                    "(architectures=['NVEmbedModel'] sets latent_pool and "
                    "bidirectional)"
                )
        if any(k.startswith("model.") for k in state):
            state = _strip(state, "model.")
        has_bias = "layers.0.self_attn.q_proj.bias" in state
        if has_bias != cfg.qkv_bias:
            raise ValueError(
                f"checkpoint qkv bias presence ({has_bias}) does not match "
                f"EncoderConfig.qkv_bias ({cfg.qkv_bias}); set "
                "EncoderConfig(qkv_bias=...) to match the checkpoint (HF config "
                "field: attention_bias)"
            )
        state.update(_with_prefix("latent_pool.", head or {}))
    elif cfg.arch == "deepseek_v3":
        if any(k.startswith("model.") for k in state):
            state = _strip(state, "model.")
        state = _stack_experts(state, cfg)
    else:
        for prefix in ("roberta.", "bert.", "model."):
            if any(k.startswith(prefix + "embeddings.") for k in state):
                state = _strip(state, prefix)
                break
    with torch.device("meta"):
        wanted = NewsEncoder(cfg).state_dict().keys()
    return {k: torch.as_tensor(state[k]) for k in wanted if k in state}
