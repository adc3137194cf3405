"""Wrapper for ring_scatter (collector placement)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ring_scatter import kernel as K
from repro_torch.kernels.ring_scatter import ref as REF


def ring_scatter(memory, entry_valid, payloads, flow, hist, mask,
                 backend=None):
    """Write each masked payload row verbatim at (flow, hist), last write
    wins in report order, and mark the cell valid — in place on
    ``memory`` / ``entry_valid``. Kernel on CUDA tensors, plain version
    on CPU tensors or under ``backend="ref"``."""
    if dispatch.use_kernel(memory, backend):
        return K.ring_scatter_cuda(memory, entry_valid, payloads,
                                   flow.to(torch.int64).contiguous(),
                                   hist.to(torch.int64).contiguous(), mask)
    return REF.ring_scatter_ref(memory, entry_valid, payloads, flow, hist,
                                mask)
