"""Binding of the CUDA kernel ``flow_moments`` (csrc/flow_moments.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (CudaKernel, check_args, ptr,
                                      stream_ptr)

N_REG = 7

KERNEL = CudaKernel(
    "flow_moments",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    replaces="src/repro/kernels/flow_moments/kernel.py:54",
    device_fns=("flow_moments_kernel",))


def flow_moments_cuda(regs, slots, deltas, valid) -> torch.Tensor:
    """(F, 7) registers + (E,) int64 slots + (E, 7) deltas + (E,) validity
    -> a new (F, 7) tensor, ``regs`` plus the valid deltas mod 2^32; same
    contract as ``ref.flow_moments_ref``. u32 words as int32 bit
    patterns."""
    F = regs.shape[0]
    E = slots.shape[0]
    dev = regs.device
    checks = (("regs", regs, torch.int32, (F, N_REG)),
              ("slots", slots, torch.int64, (E,)),
              ("deltas", deltas, torch.int32, (E, N_REG)),
              ("valid", valid, torch.bool, (E,)))
    check_args(dev, checks)
    out = regs.clone()                  # the kernel accumulates in place
    if E == 0:                          # nothing to add, nothing launched
        return out
    KERNEL.launch(ptr(out), ptr(slots), ptr(deltas), ptr(valid), E, F,
                  stream_ptr(dev))
    return out
