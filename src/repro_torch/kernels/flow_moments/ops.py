"""Wrapper for flow_moments — the ``accumulate_fn`` plugged into
``repro_torch.core.reporter.ingest`` (the multipass ingest path)."""
from __future__ import annotations

import torch

from repro_torch import u32 as U
from repro_torch.kernels import dispatch
from repro_torch.kernels.flow_moments import kernel as K
from repro_torch.kernels.flow_moments import ref as REF


def flow_moments(regs, slots, deltas, valid, backend=None) -> torch.Tensor:
    """regs (F, 7) u32 + slots (E,) + deltas (E, 7) u32 + valid (E,) bool
    -> (F, 7) u32: each valid event's deltas added into its slot's
    registers mod 2^32 (slots outside [0, F) dropped). Kernel on CUDA
    tensors, plain version on CPU tensors or under ``backend="ref"``."""
    if dispatch.use_kernel(regs, backend):
        if deltas.dtype != torch.int32:
            deltas = U.narrow(deltas)
        return K.flow_moments_cuda(regs.contiguous(),
                                   slots.to(torch.int64).contiguous(),
                                   deltas.contiguous(), valid.contiguous())
    return REF.flow_moments_ref(regs, slots, deltas, valid)
