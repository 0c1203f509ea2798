"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without CUDA raises: the port
    never falls back to the CPU on its own; callers pass ``device="cpu"``.

    On CUDA this also turns TF32 off for matrix products and cuDNN, so a
    float32 model computes in true float32 as it does on the CPU and in the
    JAX reference (PyTorch's default lets cuDNN use TF32)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
