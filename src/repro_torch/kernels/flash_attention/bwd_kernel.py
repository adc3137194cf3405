"""Binding of the CUDA kernel ``flash_attention_bwd``
(csrc/flash_attention_bwd.cu, K7): the gradient of K6's attention."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_args, ptr, stream_ptr
from repro_torch.kernels.flash_attention.kernel import DTYPES, MAX_HEAD_DIM

KERNEL = CudaKernel(
    "flash_attention_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    replaces="src/repro/models/attention.py:146",
    device_fns=("attn_bwd_dsum_kernel", "attn_bwd_dkdv_kernel",
                "attn_bwd_dq_kernel"))


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, group: int = 1,
                             causal: bool = True, scale=None):
    """Same contract as ``ref.flash_attention_bwd_ref``: q, o, do (BH, Sq,
    D|Dv) and k, v (BH // group, Sk, D|Dv) in f32 or bf16, lse (BH, Sq)
    f32 from K6 -> (dq, dk, dv) in the inputs' dtype. Head dims up to 128,
    any Sq and Sk. One call launches the kernel's three passes."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = v.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes 1.."
                         f"{MAX_HEAD_DIM}")
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"q has {BH} heads; k/v have {BHkv} with group "
                         f"{group}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    dev = q.device
    dt = q.dtype
    check_args(dev, (("q", q, dt, (BH, Sq, D)), ("k", k, dt, (BHkv, Sk, D)),
                     ("v", v, dt, (BHkv, Sk, Dv)), ("o", o, dt, (BH, Sq, Dv)),
                     ("do", do, dt, (BH, Sq, Dv)),
                     ("lse", lse, torch.float32, (BH, Sq))))
    scale = D ** -0.5 if scale is None else float(scale)
    dsum = torch.empty(BH, Sq, dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                  ptr(dsum), ptr(dq), ptr(dk), ptr(dv), BH, group, Sq, Sk, D,
                  Dv, scale, int(causal), DTYPES[dt], stream_ptr(dev))
    return dq, dk, dv
