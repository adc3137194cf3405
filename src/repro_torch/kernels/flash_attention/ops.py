"""Wrapper for flash_attention (the prefill and training attention of the
model path) and its gradient.

K6 (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention_pallas`` (src/repro/kernels/flash_attention/kernel.py).
It is bound by operations: 4·BH·Sq·Sk·D/2 multiply-adds for causal
attention against a few tens of MB of q/k/v/o, so it belongs on the
tensor cores. bf16 with (D, Dv) in {(64, 64), (128, 128)} runs the
``pingpong`` kernel (two consumer warpgroups taking turns on the tensor
cores, a work plan balanced on the host), bf16 at (80, 80) (zamba2's)
and (192, 128) (MLA's) the ``wgmma`` kernel (TMA-fed K/V ring, both
products on the tensor cores, the online softmax in registers); f32 and
other head dims run the SIMT kernel (f32 FMAs), far above the bound.
``kernel.variant`` names the one that runs, and
``kernel.KERNEL.launches_by_variant`` counts them. All keep the (Sq, Sk)
scores out of device memory.

The gradient: when an input requires grad, :func:`flash_attention` runs
:class:`FlashAttention`, whose forward is K6 writing each row's
logsumexp too, and whose backward is K7 (``csrc/flash_attention_bwd.cu``,
``bwd_kernel.py``), which recomputes p from it as the reference's
``_flash_core_bwd`` does. It saves q, k, v, o and lse: nothing of size
(Sq, Sk).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as REF


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: K6 forward and K7 backward on CUDA
    tensors, the plain versions on CPU tensors or under
    ``backend="ref"``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, backend, q_offset):
        if dispatch.use_kernel(q, backend):
            o, lse = K.flash_attention_cuda(q, k, v, group=group,
                                            causal=causal, scale=scale,
                                            with_lse=True, q_offset=q_offset)
        else:
            o, lse = REF.flash_attention_lse_ref(q, k, v, group=group,
                                                 causal=causal, scale=scale,
                                                 q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, scale, backend, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, backend, q_offset = ctx.args
        fn = (BK.flash_attention_bwd_cuda
              if dispatch.use_kernel(q, backend)
              else REF.flash_attention_bwd_ref)
        dq, dk, dv = fn(q, k, v, o, lse, do.contiguous(), group=group,
                        causal=causal, scale=scale, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, group: int = 1, causal: bool = True,
                    scale=None, backend=None, q_offset: int = 0
                    ) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (BH, Sq, Dv); query
    head ``bh`` reads kv head ``bh // group``; under the causal mask query
    row i keeps keys 0..q_offset + i (a negative offset raises
    ValueError). Kernel on CUDA tensors, plain version on CPU tensors or
    under ``backend="ref"``; with a gradient (:class:`FlashAttention`)
    when an input requires one."""
    q_offset = REF.check_q_offset(q_offset)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, group, causal, scale, backend,
                                    q_offset)
    if dispatch.use_kernel(q, backend):
        return K.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                      scale=scale, q_offset=q_offset)
    return REF.flash_attention_ref(q, k, v, group=group, causal=causal,
                                   scale=scale, q_offset=q_offset)
