"""Weights and the news table, made on the run's device from the seed, in
one draw each, in float32."""

from __future__ import annotations

import math

import torch


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of a run's draws."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % 2**63)


def make_params(shapes: dict, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter of ``shapes`` (name -> (shape, init)) from one normal
    draw: ``linear`` weights scaled by fan-in ** -0.5, ``bias`` by 0.02,
    ``norm_weight`` 1 + 0.1 x, ``normal`` as drawn."""
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for (name, (shape, init)), n in zip(shapes.items(), sizes):
        x = flat[start : start + n].view(shape)
        start += n
        if init == "linear":
            x = x * shape[-1] ** -0.5
        elif init == "bias":
            x = x * 0.02
        elif init == "norm_weight":
            x = 1.0 + 0.1 * x
        elif init != "normal":
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = x.contiguous()
    return out


def news_table(rows: int, dim: int, gen: torch.Generator, device) -> torch.Tensor:
    """[rows, dim] float32 rows of unit norm."""
    t = torch.randn(rows, dim, generator=gen, device=device)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
