"""Binding of the CUDA kernel ``flash_attention`` (csrc/flash_attention.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_args, ptr, stream_ptr

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention/kernel.py:65",
    device_fns=("flash_attention_kernel",))


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         scale=None) -> torch.Tensor:
    """Same contract as ``ref.flash_attention_ref``; f32 or bf16, head
    dims up to 128, any Sq and Sk."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = k.shape[0], k.shape[1], v.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"q has {BH} heads; k/v have {BHkv} with group "
                         f"{group}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes 1.."
                         f"{MAX_HEAD_DIM}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    dev = q.device
    check_args(dev, (("q", q, q.dtype, (BH, Sq, D)),
                     ("k", k, q.dtype, (BHkv, Sk, D)),
                     ("v", v, q.dtype, (BHkv, Sk, Dv))))
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty(BH, Sq, Dv, dtype=q.dtype, device=dev)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), BH, group, Sq, Sk, D,
                  Dv, scale, int(causal), DTYPES[q.dtype], stream_ptr(dev))
    return out
