"""Wrapper for flash_attention (the prefill attention of the model
serving path).

K6 (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention_pallas`` (src/repro/kernels/flash_attention/kernel.py).
It is bound by operations: 4·BH·Sq·Sk·D/2 multiply-adds for causal
attention against a few tens of MB of q/k/v/o, so it belongs on the
tensor cores. bf16 with D == Dv in {64, 128} runs the ``wgmma`` kernel
(TMA-fed K/V ring, both products on the tensor cores, the online softmax
in registers); f32 and other head dims run the SIMT kernel (f32 FMAs),
far above the bound. ``kernel.variant`` names the one that runs, and
``kernel.KERNEL.launches_by_variant`` counts them. Both keep the (Sq, Sk)
scores out of device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as REF


def flash_attention(q, k, v, *, group: int = 1, causal: bool = True,
                    scale=None, backend=None) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (BH, Sq, Dv); query
    head ``bh`` reads kv head ``bh // group``. Kernel on CUDA tensors,
    plain version on CPU tensors or under ``backend="ref"``."""
    if dispatch.use_kernel(q, backend):
        return K.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                      v.contiguous(), group=group,
                                      causal=causal, scale=scale)
    return REF.flash_attention_ref(q, k, v, group=group, causal=causal,
                                   scale=scale)
