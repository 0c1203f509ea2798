"""The system under test: the port's towers, built from a configuration and
loaded with the harness's weights. The only place, with the drivers, that
imports the port."""

from __future__ import annotations

import torch


def tower_config(cfg: dict):
    from news_recommendation_project_v2_torch.config import TowerConfig

    return TowerConfig(**cfg["tower"])


def build_tower(cfg: dict, params: dict, device) -> torch.nn.Module:
    """The port's tower of ``cfg`` on ``device``, its parameters copied from
    ``params`` (every name the tower has, and no other)."""
    from news_recommendation_project_v2_torch.models import build_tower as port_build

    with torch.device(device):
        tower = port_build(tower_config(cfg))
    state = tower.state_dict()
    if set(state) != set(params):
        raise ValueError(f"the tower's parameters {sorted(set(state) ^ set(params))} differ from the reference's")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(params[name])
    return tower


def train_config(cfg: dict, seed: int):
    from news_recommendation_project_v2_torch.config import TrainConfig

    return TrainConfig(**cfg["train"], seed=seed)


def compiled(data, news: int):
    """The generator's behaviours as the trainers' ``CompiledBehaviors``
    (every row with history)."""
    import numpy as np

    from news_recommendation_project_v2_torch.data.compiler import CompiledBehaviors

    rows = np.arange(data.rows, dtype=np.int32)
    return CompiledBehaviors(
        news_ids=np.arange(news).astype(str),
        imp_rev=data.imp_rev,
        imp_row=np.repeat(rows, data.imp_lens),
        imp_lens=data.imp_lens,
        hist_rev=data.hist_rev,
        hist_row=np.repeat(rows, data.hist_lens),
        hist_lens=data.hist_lens,
        hist_row_index=rows,
        labels_flat=data.labels,
        label_present=True,
    )
