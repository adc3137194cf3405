"""Wrapper for derived_features (the standalone enrichment stage of the
unfused path)."""
from __future__ import annotations

import torch

from repro_torch.core import wire as WIRE
from repro_torch.kernels import dispatch
from repro_torch.kernels.derived_features import kernel as K
from repro_torch.kernels.derived_features import ref as REF


def derived_features(entries, valid, cfg, backend=None) -> torch.Tensor:
    """(N, H, 16) u32 history entries + (N, H) bool -> (N, derived_dim)
    f32. Kernel on CUDA tensors, plain version on CPU tensors or under
    ``backend="ref"``."""
    if dispatch.use_kernel(entries, backend):
        return K.derived_features_cuda(entries.contiguous(),
                                       valid.contiguous(), cfg.derived_dim,
                                       WIRE.resolve(cfg))
    return REF.derived_features_ref(entries, valid, cfg)
