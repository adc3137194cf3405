"""Binding of the CUDA kernel ``ring_scatter`` (csrc/ring_scatter.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (CudaKernel, check_args, ptr,
                                      stream_ptr)

WORDS = 16

KERNEL = CudaKernel(
    "ring_scatter",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/ring_scatter/kernel.py:49",
    device_fns=("reset_kernel", "claim_kernel", "write_kernel"))


def ring_scatter_cuda(memory, entry_valid, payloads, flow, hist, mask):
    """Place payloads in the ring in place; same contract as
    ``ref.ring_scatter_ref``."""
    F, H, W = memory.shape
    R = payloads.shape[0]
    dev = memory.device
    checks = (("memory", memory, torch.int32, (F, H, WORDS)),
              ("entry_valid", entry_valid, torch.bool, (F, H)),
              ("payloads", payloads, torch.int32, (R, WORDS)),
              ("flow", flow, torch.int32, (R,)),
              ("hist", hist, torch.int32, (R,)),
              ("mask", mask, torch.bool, (R,)))
    check_args(dev, checks)
    # per-cell winner scratch; the kernel resets only the cells it
    # touches, so it starts uninitialised
    winner = torch.empty(F * H, dtype=torch.int32, device=dev)
    KERNEL.launch(ptr(memory), ptr(entry_valid), ptr(payloads), ptr(flow),
                  ptr(hist), ptr(mask), ptr(winner), R, F, H,
                  stream_ptr(dev))
    return memory, entry_valid
