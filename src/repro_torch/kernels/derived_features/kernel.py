"""Binding of the CUDA kernel ``derived_features``
(csrc/derived_features.cu, whose body is the shared
``csrc/derive_block.cuh``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import wire as WIRE
from repro_torch.kernels.build import (CudaKernel, check_args, ptr,
                                      stream_ptr)
from repro_torch.kernels.gather_enrich.kernel import WORDS, check_ring

KERNEL = CudaKernel(
    "derived_features",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="src/repro/kernels/derived_features/kernel.py:73",
    device_fns=("derived_features_kernel",))


def derived_features_cuda(entries, valid, derived_dim: int,
                          wire: WIRE.WireFormat) -> torch.Tensor:
    """(N, H, 16) entries + (N, H) validity -> (N, D) f32; same contract
    as ``ref.derived_features_ref``."""
    N, H, W = entries.shape
    dev = entries.device
    checks = (("entries", entries, torch.int32, (N, H, WORDS)),
              ("valid", valid, torch.bool, (N, H)))
    check_args(dev, checks)
    check_ring(entries, wire)
    out = torch.empty(N, derived_dim, dtype=torch.float32, device=dev)
    hf = wire.payload_hist
    KERNEL.launch(ptr(entries), ptr(valid), ptr(out), N, H, derived_dim,
                  hf.word, hf.shift, hf.mask, stream_ptr(dev))
    return out
