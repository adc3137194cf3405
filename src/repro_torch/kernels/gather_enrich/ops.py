"""Wrapper for gather_enrich (pipeline enrichment stage)."""
from __future__ import annotations

import torch

from repro_torch.core import wire as WIRE
from repro_torch.kernels import dispatch
from repro_torch.kernels.gather_enrich import kernel as K
from repro_torch.kernels.gather_enrich import ref as REF


def gather_enrich(memory, entry_valid, local_flow, cfg,
                  backend=None) -> torch.Tensor:
    """(F, H, 16) ring + (F, H) validity + (R,) local flow ids (clamped to
    [0, F)) -> (R, derived_dim) f32. Kernel on CUDA tensors, plain
    version on CPU tensors or under ``backend="ref"``."""
    if dispatch.use_kernel(memory, backend):
        return K.gather_enrich_cuda(memory, entry_valid,
                                    local_flow.to(torch.int32).contiguous(),
                                    cfg.derived_dim, WIRE.resolve(cfg))
    return REF.gather_enrich_ref(memory, entry_valid, local_flow, cfg)
