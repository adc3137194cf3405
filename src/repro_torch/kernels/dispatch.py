"""Kernel selection for the port: the tensor's device decides.

Every kernel family has a wrapper (``kernels/<family>/ops.py``) that
either launches its hand-written CUDA kernel or runs the plain PyTorch
version in the family's ``ref.py``:

* a tensor on the CPU runs the plain version — only because it lies on
  the CPU;
* a CUDA tensor launches the kernel, or the launch raises. Nothing
  catches that and falls back;
* ``backend="ref"`` forces the plain version on any device. It exists so
  the card can hold a kernel against its plain version on the same
  inputs (``chip_smoke.py``, the GPU-marked tests).

Backend names: ``"auto"`` (the default, device-driven as above),
``"cuda"`` (the same, but a CPU tensor raises instead of running the
plain version) and ``"ref"``. The reference package's TPU backends
(``"pallas"``, ``"interpret"``) have no meaning here and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

BACKENDS = ("auto", "cuda", "ref")
TPU_BACKENDS = ("pallas", "interpret")


def check_backend(backend: Optional[str]) -> str:
    """Validate a backend name (None and "" mean "auto")."""
    b = backend or "auto"
    if b in TPU_BACKENDS:
        raise ValueError(
            f"kernel backend {b!r} is a TPU backend of the JAX package; "
            f"the PyTorch port takes {list(BACKENDS)}")
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; expected one of "
                         f"{list(BACKENDS)}")
    return b


def use_kernel(t: torch.Tensor, backend: Optional[str] = None) -> bool:
    """True when a wrapper must launch its CUDA kernel for tensor ``t``."""
    b = check_backend(backend)
    if b == "ref":
        return False
    if t.is_cuda:
        return True
    if b == "cuda":
        raise RuntimeError(
            f"kernel backend 'cuda' was asked for a tensor on {t.device}; "
            "move the data to the card or use backend='auto'")
    return False
