"""The port's latent tower against the JAX package's ``LatentAttentionTower``
on identical numpy-seeded weights and inputs, on the CPU (where the port's
kernel wrappers compute their plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.models.latent_attention import (
    LatentAttentionTower as JaxTower,
)
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SMALL = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)
FULL = TowerConfig()  # published width: D=1024, 64 latents, 8 heads x 512


def _inputs(rng, cfg, b, l):
    emb = rng.standard_normal((b, l, cfg.reduced_dim)).astype(np.float32)
    mask = (rng.random((b, l)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    emb *= mask[..., None]  # pad tokens are zero rows, as the Ranker gathers them
    return emb, mask


def _run_both(rng, cfg, use_fused, with_mask, b, l):
    params = random_latent_params(rng, cfg)
    emb, mask = _inputs(rng, cfg, b, l)
    port = build_tower(cfg)
    port.load_state_dict(latent_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(emb), torch.from_numpy(mask) if with_mask else None)
    jt = JaxTower(
        dim=cfg.reduced_dim,
        num_latents=cfg.num_latents,
        heads=cfg.num_heads,
        dim_head=cfg.latent_dim_head,
        use_fused=use_fused,
        dtype=None if cfg.compute_dtype == "float32" else jnp.bfloat16,
    )
    want = jax.jit(jt.apply)(params, emb, mask if with_mask else None)
    return got.float().numpy(), np.asarray(want, dtype=np.float32)


@pytest.mark.parametrize("with_mask", [True, False], ids=["pooled", "per_token"])
@pytest.mark.parametrize("use_fused", [False, True], ids=["jax_plain", "jax_pallas"])
def test_small_width_f32(rng, use_fused, with_mask):
    got, want = _run_both(rng, SMALL, use_fused, with_mask, b=4, l=12)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "use_fused,with_mask", [(False, True), (True, False)], ids=["plain_pooled", "pallas_per_token"]
)
def test_full_width_f32(rng, use_fused, with_mask):
    got, want = _run_both(rng, FULL, use_fused, with_mask, b=2, l=16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def _rel_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize(
    "cfg,use_fused,with_mask",
    [(SMALL, False, True), (SMALL, True, False), (FULL, True, True)],
    ids=["small_plain_pooled", "small_pallas_per_token", "full_pallas_pooled"],
)
def test_bf16_compute(rng, cfg, use_fused, with_mask):
    """bfloat16 matmuls, float32 LayerNorm/softmax/pool. The two frameworks
    round to bfloat16 at different points (flax rounds every Dense output and
    the GEGLU bias sum; the port keeps products, biases and the gate in
    float32 and rounds the gated product once, as the Pallas kernel does), so
    the comparison is a norm-relative error of 3e-2, bfloat16's few digits."""
    import dataclasses

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    got, want = _run_both(rng, cfg, use_fused, with_mask, b=2, l=16)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) < 3e-2


def test_fully_padded_row_stays_finite(rng):
    """A row with an all-zero mask pools to zero, not NaN (the guarded
    denominator), in both packages."""
    params = random_latent_params(rng, SMALL)
    emb, mask = _inputs(rng, SMALL, b=2, l=8)
    mask[1] = 0.0
    emb[1] = 0.0
    port = build_tower(SMALL)
    port.load_state_dict(latent_state_dict_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    want = np.asarray(JaxTower(dim=64, num_latents=8, heads=2, dim_head=16).apply(params, emb, mask))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
