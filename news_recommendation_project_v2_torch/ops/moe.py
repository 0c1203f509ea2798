"""The routed experts of a mixture-of-experts layer: the wrapper of the
grouped GEMM kernels (``csrc/moe_experts.cu``) and their plain PyTorch
version.

The rows come sorted by expert: ``xs`` [M, D] holds expert 0's rows, then
expert 1's, ..., ``offsets`` [E + 1] (int32, on the rows' device) the first
row of each expert and M last. The experts' weights are stacked: ``w_gate_up``
[E, 2I, D] (each expert's ``gate_proj`` rows, then its ``up_proj`` rows) and
``w_down`` [E, D, I], in ``nn.Linear`` layout. ``pair_weight`` [M] float32 is
each row's routing weight. The result is float32 [M, D]:

    h = silu(xs W_gate^T) * (xs W_up^T)      (rounded to the rows' type, as
                                              torch's ops in that type round)
    y = round(h W_down^T) * pair_weight

On the card two launches compute it, bfloat16 only (``grouped_swiglu`` and
``grouped_down``); they read the offsets from device memory, so the host
never learns how many rows an expert has. On the CPU the plain version loops
over the experts. ``routed_experts.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_GATE_UP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DOWN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_EXPERTS = 256  # the kernels keep each expert's tile offsets in shared memory


def reference_routed_experts(xs, offsets, w_gate_up, w_down, pair_weight) -> torch.Tensor:
    """The plain version: one expert at a time (reads ``offsets`` on the host,
    so on the card it waits for the device)."""
    i = w_down.shape[-1]
    bounds = offsets.tolist()
    y = torch.zeros(xs.shape[0], w_down.shape[1], dtype=torch.float32, device=xs.device)
    for e in range(w_gate_up.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        x = xs[lo:hi]
        w = w_gate_up[e].to(x.dtype)
        h = F.silu(F.linear(x, w[:i])) * F.linear(x, w[i:])
        y[lo:hi] = F.linear(h, w_down[e].to(x.dtype)).float() * pair_weight[lo:hi, None]
    return y


def _check(xs, offsets, w_gate_up, w_down, pair_weight) -> None:
    _build.validate("moe_experts", (xs, w_gate_up, w_down))
    e, two_i, d = w_gate_up.shape
    if xs.dtype != torch.bfloat16:
        raise TypeError(f"moe_experts: the kernels take bfloat16 rows, got {xs.dtype}")
    if xs.dim() != 2 or xs.shape[1] != d or two_i % 2 or tuple(w_down.shape) != (e, d, two_i // 2):
        raise ValueError(
            f"moe_experts: rows {tuple(xs.shape)}, w_gate_up {tuple(w_gate_up.shape)} and w_down "
            f"{tuple(w_down.shape)} do not fit [M, D], [E, 2I, D], [E, D, I]"
        )
    if not 1 <= e <= MAX_EXPERTS or d % 64 or (two_i // 2) % 64:
        raise ValueError(f"moe_experts: needs 1 to {MAX_EXPERTS} experts and D, I multiples of 64, got E={e} D={d}")
    if offsets.dtype != torch.int32 or offsets.shape != (e + 1,) or offsets.device != xs.device:
        raise ValueError("moe_experts: offsets must be int32 [E + 1] on the rows' device")
    if pair_weight.dtype != torch.float32 or pair_weight.shape != (xs.shape[0],) or not pair_weight.is_contiguous():
        raise ValueError("moe_experts: pair_weight must be contiguous float32 [M]")


def _where(x: torch.Tensor) -> tuple:
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


def grouped_swiglu(xs, offsets, w_gate_up) -> torch.Tensor:
    """``silu(xs W_gate^T) * (xs W_up^T)`` of each row under its expert's
    weights, [M, I] in the rows' type: one launch."""
    e, two_i, d = w_gate_up.shape
    m, i = xs.shape[0], two_i // 2
    h = torch.empty(m, i, dtype=xs.dtype, device=xs.device)
    if m:
        fn = _build.function("moe_experts", "moe_experts_gate_up_bf16", _GATE_UP_ARGTYPES)
        code = fn(xs.data_ptr(), w_gate_up.data_ptr(), offsets.data_ptr(), h.data_ptr(), m, e, d, i, *_where(xs))
        _build.check("moe_experts", code)
        routed_experts.launches += 1
    return h


def grouped_down(h, offsets, w_down, pair_weight) -> torch.Tensor:
    """``round(h W_down^T) * pair_weight`` of each row under its expert's
    weights, float32 [M, D]: one launch."""
    e, d, i = w_down.shape
    m = h.shape[0]
    y = torch.empty(m, d, dtype=torch.float32, device=h.device)
    if m:
        fn = _build.function("moe_experts", "moe_experts_down_bf16", _DOWN_ARGTYPES)
        code = fn(
            h.data_ptr(), w_down.data_ptr(), offsets.data_ptr(), pair_weight.data_ptr(), y.data_ptr(), m, e, d, i,
            *_where(h),
        )
        _build.check("moe_experts", code)
        routed_experts.launches += 1
    return y


def routed_experts(xs, offsets, w_gate_up, w_down, pair_weight) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the two
    kernels (bfloat16) or raise. Forward only."""
    if _build.on_cpu((xs, offsets, w_gate_up, w_down, pair_weight)):
        return reference_routed_experts(xs, offsets, w_gate_up, w_down, pair_weight)
    _check(xs, offsets, w_gate_up, w_down, pair_weight)
    h = grouped_swiglu(xs, offsets, w_gate_up)
    return grouped_down(h, offsets, w_down, pair_weight)


routed_experts.launches = 0
