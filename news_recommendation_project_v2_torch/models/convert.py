"""JAX/flax parameters -> the port's ``state_dict``.

The inverse of the JAX package's ``convert_latent_attention``: a flax
``Dense.kernel`` is [in, out] and a torch ``Linear.weight`` [out, in], so
kernels transpose; a flax ``LayerNorm.scale`` is a torch ``weight``. Arrays
arrive as numpy (or anything ``np.asarray`` reads) and leave as float32
tensors; ``load_state_dict`` casts them to the tower's parameter type.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def random_latent_params(rng: np.random.Generator, cfg) -> dict:
    """Random latent-tower parameters of ``cfg``'s (a ``TowerConfig``)
    widths, as numpy in the JAX package's layout (flax kernels [in, out],
    LeCun-normal scale; LayerNorm scales and all biases perturbed so that they
    matter). One seed gives both packages the same weights."""
    d, inner = cfg.reduced_dim, cfg.num_heads * cfg.latent_dim_head

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def dense(i, o, bias=True):
        p = {"kernel": normal(i, o, scale=i**-0.5)}
        if bias:
            p["bias"] = normal(o, scale=0.02)
        return p

    def ln():
        return {"scale": 1.0 + normal(d, scale=0.1), "bias": normal(d, scale=0.1)}

    return {
        "params": {
            "latents": normal(cfg.num_latents, d),
            "cross_prenorm": ln(),
            "cross_prenorm_context": ln(),
            "cross_attn": {
                "to_q": dense(d, inner, bias=False),
                "to_kv": dense(d, 2 * inner, bias=False),
                "to_out": dense(inner, d, bias=False),
            },
            "ff_prenorm": ln(),
            "cross_ff": {"proj_in": dense(d, 8 * d), "proj_out": dense(4 * d, d)},
        }
    }


def latent_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``LatentAttentionTower`` param tree (with or without the outer
    ``{"params": ...}``) -> a ``state_dict`` for the port's tower."""
    p = params.get("params", params)
    attn, ff = "cross_attend_blocks.0", "cross_attend_blocks.1"
    sd = {"latents": _t(p["latents"])}
    for prefix, ln in (
        (f"{attn}.norm", "cross_prenorm"),
        (f"{attn}.norm_context", "cross_prenorm_context"),
        (f"{ff}.norm", "ff_prenorm"),
    ):
        sd[f"{prefix}.weight"] = _t(p[ln]["scale"])
        sd[f"{prefix}.bias"] = _t(p[ln]["bias"])
    for name in ("to_q", "to_kv", "to_out"):
        sd[f"{attn}.fn.{name}.weight"] = _t(np.asarray(p["cross_attn"][name]["kernel"]).T)
    for idx, name in (("0", "proj_in"), ("2", "proj_out")):
        dense = p["cross_ff"][name]
        sd[f"{ff}.fn.net.{idx}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"{ff}.fn.net.{idx}.bias"] = _t(dense["bias"])
    return sd
