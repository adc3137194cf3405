"""Binding of the CUDA kernel ``gather_enrich`` (csrc/gather_enrich.cu,
whose body is the shared ``csrc/derive_block.cuh``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import wire as WIRE
from repro_torch.kernels.build import (CudaKernel, check_args, ptr,
                                      stream_ptr)

WORDS = 16
# csrc/derive_block.cuh kMaxHistory: one flow's entries must fit in one
# block's shared memory (84 B per entry)
MAX_HISTORY = 2767

KERNEL = CudaKernel(
    "gather_enrich",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="src/repro/kernels/gather_enrich/kernel.py:66",
    device_fns=("gather_enrich_kernel",))


def check_ring(entries, wire: WIRE.WireFormat) -> None:
    """What csrc/derive_block.cuh takes, shared by K3 and K5: the wire's
    stats in words 1-7 and hist_idx in word 13 or 15, H up to
    ``MAX_HISTORY``, and entries 16-byte aligned (16-byte loads)."""
    if (wire.payload_stats != (1, 8) or wire.payload_hist.word not in (13, 15)
            or wire.payload_words != WORDS):
        raise ValueError(f"wire format {wire.name!r}: the kernel reads stats "
                         "from words 1-7 and hist_idx from word 13 or 15")
    if entries.shape[1] > MAX_HISTORY:
        raise ValueError(f"history {entries.shape[1]} > {MAX_HISTORY}: one "
                         "flow's entries must fit in a block's shared memory")
    if entries.data_ptr() % 16:
        raise ValueError("ring entries must be 16-byte aligned for the "
                         "kernel's 16-byte loads")


def gather_enrich_cuda(memory, entry_valid, local_flow, derived_dim: int,
                       wire: WIRE.WireFormat) -> torch.Tensor:
    """(F, H, 16) ring + (F, H) validity + (R,) local flows -> (R, D) f32;
    same contract as ``ref.gather_enrich_ref``."""
    F, H, W = memory.shape
    R = local_flow.shape[0]
    dev = memory.device
    checks = (("memory", memory, torch.int32, (F, H, WORDS)),
              ("entry_valid", entry_valid, torch.bool, (F, H)),
              ("local_flow", local_flow, torch.int32, (R,)))
    check_args(dev, checks)
    check_ring(memory, wire)
    out = torch.empty(R, derived_dim, dtype=torch.float32, device=dev)
    hf = wire.payload_hist
    KERNEL.launch(ptr(memory), ptr(entry_valid), ptr(local_flow), ptr(out),
                  R, F, H, derived_dim, hf.word, hf.shift, hf.mask,
                  stream_ptr(dev))
    return out
