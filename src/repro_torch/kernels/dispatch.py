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

Backend selection precedence (strongest first), the reference's:

1. an explicit ``backend=`` argument (``"auto"`` defers);
2. the ``REPRO_KERNEL_BACKEND`` environment variable
   (``repro_torch.configs.env``);
3. ``DFAConfig.kernel_backend``;
4. ``"auto"``.

A malformed value raises wherever it sits in the ladder, even when a
stronger setting would win. ``REPRO_GATHER_VARIANT`` and
``REPRO_INGEST_VARIANT`` accept only auto: the TPU kernels' VMEM
variants have no counterpart among the CUDA kernels.

:func:`resolve_event_tile` consults the tuned-config registry
(``kernels.tuning``) for K1's event tile under the name of what runs the
segment sums (:func:`route`): a tuned value for the exact event count
beats ``DFAConfig.event_tile``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import env as ENV

BACKENDS = ("auto", "cuda", "ref")
TPU_BACKENDS = ENV.KERNEL_BACKEND.tpu_only


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


def resolve_backend(explicit: Optional[str] = None, cfg=None) -> str:
    """The backend under the precedence above: one of BACKENDS."""
    env = ENV.read_choice(ENV.KERNEL_BACKEND.name)   # validated even if unused
    if explicit not in (None, "", "auto"):
        return check_backend(explicit)
    if env is not None:
        return env
    return check_backend(getattr(cfg, "kernel_backend", "auto") or "auto")


def check_variants() -> None:
    """Raise if ``REPRO_GATHER_VARIANT`` or ``REPRO_INGEST_VARIANT`` is
    set to anything but auto."""
    ENV.read_choice(ENV.GATHER_VARIANT.name)
    ENV.read_choice(ENV.INGEST_VARIANT.name)


def route(t: torch.Tensor, backend: Optional[str] = None) -> str:
    """``"cuda"`` where a wrapper launches its kernel for ``t``, else
    ``"ref"`` (its plain version): the backend name a tuned value is
    recorded and looked up under."""
    return "cuda" if use_kernel(t, backend) else "ref"


def resolve_event_tile(cfg, events: int, route_name: str) -> int:
    """K1's event tile: a tuned value for this event count under
    ``route_name`` beats ``cfg.event_tile`` (arming a registry is an
    explicit opt-in). The kernel's bounds are the caller's
    (``ingest_update.kernel.clamp_tile``)."""
    from repro_torch.kernels import tuning     # lazy: import-light dispatch
    tuned = tuning.lookup_value(cfg, "ingest_update.event_tile", route_name,
                                (int(events),))
    if tuned is None:
        return int(getattr(cfg, "event_tile", 256))
    t = int(tuned)
    if t < 1:
        raise ValueError(
            f"tuned ingest_update.event_tile for key ({int(events)},) is "
            f"{t}; tiles must be >= 1 — the registry file is corrupt")
    return t
