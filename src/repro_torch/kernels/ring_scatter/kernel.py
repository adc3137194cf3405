"""Binding of the CUDA kernel ``ring_scatter`` (csrc/ring_scatter.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (CudaKernel, check_args, ptr,
                                      stream_ptr)

WORDS = 16
MAX_CELLS = 1 << 31     # cells are int32 keys of the kernel's shared table
MAX_ROWS = (1 << 31) - 1

KERNEL = CudaKernel(
    "ring_scatter",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/ring_scatter/kernel.py:49",
    device_fns=("ring_scatter_kernel",))

# an empty kernel with ring_scatter's launch shape: its device time is the
# floor under ring_scatter's (chip_smoke.py reads it beside K2's time)
FLOOR = CudaKernel("ring_scatter", [ctypes.c_int, ctypes.c_void_p],
                   replaces="", device_fns=("empty_kernel",),
                   symbol="ring_scatter_floor")
# the C entry that reports the kernel's rows per round (launches nothing)
ROUND = CudaKernel("ring_scatter", [], replaces="", device_fns=(),
                   symbol="ring_scatter_round_rows")


def check_ring(memory, payloads) -> None:
    """What csrc/ring_scatter.cu takes: F*H < 2^31 cells and R < 2^31
    rows (int32 keys and rows), ring and payloads 16-byte aligned (16-byte
    copies)."""
    F, H = memory.shape[0], memory.shape[1]
    if F * H >= MAX_CELLS:
        raise ValueError(f"ring of {F} x {H} = {F * H} cells: the kernel "
                         f"addresses fewer than 2^31")
    if payloads.shape[0] > MAX_ROWS:
        raise ValueError(f"{payloads.shape[0]} rows: the kernel addresses "
                         f"at most 2^31 - 1")
    if memory.data_ptr() % 16 or payloads.data_ptr() % 16:
        raise ValueError("ring and payloads must be 16-byte aligned for the "
                         "kernel's 16-byte copies")


def ring_scatter_cuda(memory, entry_valid, payloads, flow, hist, mask):
    """Place payloads in the ring in place; same contract as
    ``ref.ring_scatter_ref``; ``flow`` and ``hist`` are int64, as the
    collector makes them."""
    F, H, W = memory.shape
    R = payloads.shape[0]
    dev = memory.device
    checks = (("memory", memory, torch.int32, (F, H, WORDS)),
              ("entry_valid", entry_valid, torch.bool, (F, H)),
              ("payloads", payloads, torch.int32, (R, WORDS)),
              ("flow", flow, torch.int64, (R,)),
              ("hist", hist, torch.int64, (R,)),
              ("mask", mask, torch.bool, (R,)))
    check_args(dev, checks)
    check_ring(memory, payloads)
    if R == 0:                          # nothing to place, nothing launched
        return memory, entry_valid
    KERNEL.launch(ptr(memory), ptr(entry_valid), ptr(payloads), ptr(flow),
                  ptr(hist), ptr(mask), R, F, H, stream_ptr(dev))
    return memory, entry_valid


def launch_floor(R: int, device) -> None:
    """One empty kernel with ring_scatter's grid, block and shared memory
    for R rows (for timing only)."""
    FLOOR.launch(R, stream_ptr(device))


def round_rows() -> int:
    """The most rows one round of the kernel takes (builds the kernel)."""
    return ROUND.load()()
