"""The weight bridge: ``latent_state_dict_from_jax`` is the exact inverse of
the JAX package's ``convert_latent_attention``."""

import jax
import numpy as np
import pytest

from news_recommendation_project_v2_tpu.models.convert_towers import convert_latent_attention
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

SMALL = TowerConfig(reduced_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)


@pytest.mark.parametrize("cfg", [SMALL, TowerConfig()], ids=["small", "full_width"])
def test_loads_strictly_into_port_tower(rng, cfg):
    tower = build_tower(cfg)
    missing, unexpected = tower.load_state_dict(
        latent_state_dict_from_jax(random_latent_params(rng, cfg)), strict=True
    )
    assert not missing and not unexpected


def test_round_trip_through_jax_converter_is_exact(rng):
    params = random_latent_params(rng, SMALL)
    tower = build_tower(SMALL)
    tower.load_state_dict(latent_state_dict_from_jax(params), strict=True)
    back = convert_latent_attention(tower.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_accepts_inner_param_tree(rng):
    params = random_latent_params(rng, SMALL)
    outer = latent_state_dict_from_jax(params)
    inner = latent_state_dict_from_jax(params["params"])
    assert outer.keys() == inner.keys()
    assert all((outer[k] == inner[k]).all() for k in outer)
