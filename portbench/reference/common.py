"""Plain float32 building blocks of the reference: matrix products in a
stated precision, LayerNorm, the tanh GELU and the cosine.

Nothing here imports the port. Every matrix product of the reference goes
through ``Precision``, so one switch computes the whole reference in
float32 (the configurations' precision, TF32 off), in TF32 or in bfloat16:
the lower two are the controls that the comparison has to reject. TF32 and
bfloat16 are emulated by rounding each operand's mantissa to 10 or 7 bits
(nearest, ties to even) before a float32 product, so the control reads the
same on the CPU and on the card, whatever cuBLAS's TF32 switch says.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MANTISSA_BITS = {"float32": 23, "tf32": 10, "bfloat16": 7}


def _rounded(x: torch.Tensor, bits: int) -> torch.Tensor:
    shift = 23 - bits
    xi = x.detach().float().contiguous().view(torch.int32)
    lsb = (xi >> shift) & 1
    return ((xi + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)).view(torch.float32).view(x.shape)


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to ``bits`` mantissa bits, to nearest, ties to
    even (finite values); the gradient passes through unchanged."""
    if bits >= 23:
        return x
    return x + (_rounded(x, bits) - x).detach()


class _ProductOut(torch.autograd.Function):
    """A product's output: rounded or not going forward, and the gradient
    that reaches it rounded going back, so the backward's products take
    operands of the same precision as the forward's."""

    @staticmethod
    def forward(ctx, y, bits: int, round_forward: bool):
        ctx.bits = bits
        return _rounded(y, bits) if round_forward else y.clone()

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, ctx.bits), None, None


class Precision:
    """The precision of the reference's matrix products, forward and
    backward. ``float32`` with TF32 off; ``tf32`` rounds the operands to TF32
    and sums in float32; ``bfloat16`` rounds the operands and the result to
    bfloat16."""

    def __init__(self, mode: str = "float32"):
        if mode not in MANTISSA_BITS:
            raise ValueError(f"precision {mode!r}: want one of {sorted(MANTISSA_BITS)}")
        self.mode = mode
        self.bits = MANTISSA_BITS[mode]

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return round_mantissa(x, self.bits)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        if self.bits >= 23:
            return y
        return _ProductOut.apply(y, self.bits, self.mode == "bfloat16")

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        y = self._out(F.linear(self._in(x), self._in(w)))
        if b is None:
            return y
        y = y + b
        return round_mantissa(y, self.bits) if self.mode == "bfloat16" else y

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._out(torch.einsum(spec, self._in(a), self._in(b)))


def float32_matmuls() -> None:
    """Turn TF32 off for cuBLAS and cuDNN, so a float32 product is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def cosine(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine of two [..., D] stacks, each norm at least ``eps``."""
    nu = torch.sqrt((u * u).sum(-1)).clamp_min(eps)
    nv = torch.sqrt((v * v).sum(-1)).clamp_min(eps)
    return (u * v).sum(-1) / (nu * nv)


def masked_mean_l2(states: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[U, L, D] states, [U, L] mask -> the L2-normalised mean of each row's
    real tokens (a row with none stays zero)."""
    m = mask.float()
    mean = (states * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
    return mean / torch.sqrt((mean * mean).sum(-1, keepdim=True) + 1e-12)
