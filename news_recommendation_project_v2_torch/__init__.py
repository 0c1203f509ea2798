"""PyTorch/CUDA port of ``news_recommendation_project_v2_tpu``.

The port runs on one NVIDIA Hopper card (H100, ``sm_90a``). Plain tensor code
is PyTorch; each Pallas kernel of the JAX package is a CUDA C++ kernel written
by hand (``ops/csrc/``), built by ``nvcc`` at first use and bound with
``ctypes``. The port imports nothing of the JAX package: it keeps its own copy
of every host helper it needs.

Entry points take ``device=`` and default to ``"cuda"``; without CUDA they
raise unless the caller asks for ``device="cpu"``, where every kernel wrapper
computes its plain PyTorch version instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
