"""DeepSeek-V3's mixture-of-experts block (Moonlight's): a sigmoid router
with a selection bias, routed SwiGLU experts and shared ones, over the real
tokens of a batch packed into rows.

A token's experts are the ``top_k`` of ``sigmoid(x W_r^T) + b`` (the router
in float32; ``b`` is ``e_score_correction_bias``, the ``noaux_tc`` method with
one group); its weights are the unbiased scores of those experts,
renormalised to sum to 1 (``norm_topk_prob``) and scaled by
``routed_scaling_factor``. The routed experts' outputs, weighted, add up in
float32 in the order of the picks (highest biased score first) and are
rounded to the compute type; the shared experts, one SwiGLU of
``n_shared_experts x moe_intermediate_size`` over every token, add to that.

On the card nothing here waits for the device: the token-expert pairs are
sorted by expert on the device (a stable sort; each expert's first row by
``searchsorted``), the rows gathered in that order, and the grouped kernels
(``ops.moe``) read the per-expert offsets from device memory; the combine
gathers each token's pairs back in pick order and adds them, with no
atomics. Parameter names are those of Hugging Face's ``DeepseekV3MoE``
except the experts', which are stacked (``experts.gate_up_proj`` [E, 2I, D]:
each expert's ``gate_proj`` rows, then its ``up_proj`` rows;
``experts.down_proj`` [E, D, I]); ``models.convert.encoder_state_dict_from_hf``
stacks a checkpoint's per-expert tensors.

A block may hold a share of its experts (``held=(first, count)``: experts
``first`` to ``first + count - 1`` of an expert-parallel deployment): the
router still scores all ``num_experts`` and picks its ``top_k`` among them;
the pairs of held experts are sorted first, by expert, and the others after
them, so ``offsets[count]`` (on the device) ends the held pairs and the
grouped kernels compute no row past it; the combine adds a token's held
pairs in pick order and nothing for the others. A token with no held pair
gets the shared experts alone. What the other devices' experts would add is
theirs to add.

Counters (``utils.profiling``, known on the host): ``moe.tokens_routed``
(tokens a layer routes, summed over layers), ``moe.assignments`` (their
token-expert pairs) and ``moe.grouped_launches`` (the grouped kernels'
launches); on the device, ``moe.assignments_held`` (the pairs of held
experts, read when the records are); each block runs inside the span
``moe.layer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import routed_experts
from ..utils import profiling


def swiglu(mlp: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate x) * up x)`` in x's type."""
    dt = x.dtype
    gate = F.linear(x, mlp["gate_proj"].weight.to(dt))
    up = F.linear(x, mlp["up_proj"].weight.to(dt))
    return F.linear(F.silu(gate) * up, mlp["down_proj"].weight.to(dt))


class MoEGate(nn.Module):
    """The router: [N, D] tokens -> (experts [N, top_k] int64, weights
    [N, top_k] float32), the experts in descending order of biased score."""

    def __init__(self, dim: int, num_experts: int, top_k: int, scaling: float, normalize: bool):
        super().__init__()
        self.top_k, self.scaling, self.normalize = top_k, scaling, normalize
        self.weight = nn.Parameter(torch.empty(num_experts, dim))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(num_experts))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        picked = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k, dim=-1).indices
        weight = scores.gather(1, picked)
        if self.normalize:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return picked, weight * self.scaling


class MoEExperts(nn.Module):
    """The routed experts' stacked SwiGLU weights."""

    def __init__(self, dim: int, num_experts: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(num_experts, 2 * width, dim))
        self.down_proj = nn.Parameter(torch.empty(num_experts, dim, width))


def dispatch(picked: torch.Tensor, num_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The token-expert pairs (``picked`` [N, k], flattened token-major) in
    expert order, ``order`` [N k] (stable: a token's pairs keep token order
    within an expert), and ``offsets`` [E + 1] int32, expert e's first row
    in that order; on the device, without a wait. A pick of ``num_experts``
    or more sorts after every expert's rows, past ``offsets[E]``."""
    flat = picked.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(num_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], bounds).to(torch.int32)
    return order, offsets


def held_picks(picked: torch.Tensor, first: int, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``picked`` as indices into the held experts (``first`` to ``first +
    count - 1`` become 0 to ``count - 1``, every other expert ``count``) and
    the mask [N, k] of held pairs."""
    local = picked - first
    held = (local >= 0) & (local < count)
    return torch.where(held, local, count), held


def combine(y_sorted: torch.Tensor, order: torch.Tensor, tokens: int, top_k: int,
            held: torch.Tensor | None = None) -> torch.Tensor:
    """Each token's weighted expert outputs (rows of ``y_sorted`` in
    ``order``'s order) added in the order of its picks: [N, D] float32.
    With ``held`` [N, k] the pairs it leaves out add nothing (their rows
    were never computed)."""
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=order.device)
    slot = slot.view(tokens, top_k)
    out = None
    for j in range(top_k):
        part = y_sorted.index_select(0, slot[:, j])
        if held is not None:
            part = part.masked_fill_(~held[:, j, None], 0.0)
        if out is None:
            out = part
        else:
            out += part
    return out


class MoEBlock(nn.Module):
    """[N, D] real tokens in the compute type -> [N, D]: the routed experts'
    weighted sum (float32, then rounded) plus the shared experts."""

    def __init__(self, dim: int, num_experts: int, top_k: int, width: int, shared: int, scaling: float,
                 normalize: bool, held: tuple[int, int] | None = None):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        if held is not None and not (0 <= held[0] and 1 <= held[1] and held[0] + held[1] <= num_experts):
            raise ValueError(f"MoEBlock: held experts {held} are not a range of the {num_experts} experts")
        self.held = None if held is None or tuple(held) == (0, num_experts) else (int(held[0]), int(held[1]))
        self.gate = MoEGate(dim, num_experts, top_k, scaling, normalize)
        self.experts = MoEExperts(dim, num_experts if self.held is None else self.held[1], width)
        self.shared_experts = nn.ModuleDict(
            {
                "gate_proj": nn.Linear(dim, shared * width, bias=False),
                "up_proj": nn.Linear(dim, shared * width, bias=False),
                "down_proj": nn.Linear(shared * width, dim, bias=False),
            }
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, k = x.shape[0], self.top_k
        with profiling.span("moe.layer"):
            picked, weight = self.gate(x)
            held = None
            if self.held is None:
                order, offsets = dispatch(picked, self.num_experts)
            else:
                picked, held = held_picks(picked, *self.held)
                order, offsets = dispatch(picked, self.held[1])
            xs = x.index_select(0, order // k)
            pair_weight = weight.reshape(-1)[order]
            ex = self.experts
            y_sorted = routed_experts(xs, offsets, ex.gate_up_proj.to(x.dtype), ex.down_proj.to(x.dtype), pair_weight)
            del xs
            routed = combine(y_sorted, order, n, k, held).to(x.dtype)
            del y_sorted
            out = routed + swiglu(self.shared_experts, x)
        if profiling.active():
            profiling.count("moe.tokens_routed", n)
            profiling.count("moe.assignments", n * k)
            profiling.count("moe.grouped_launches", 0 if x.is_cpu else 2)
            if self.held is not None:
                profiling.count_device("moe.assignments_held", offsets[-1])
        return out
