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

A negative query offset is split here, and the kernels never see it:
under the causal mask the first n0 = min(-q_offset, Sq) rows keep no key.
The reference's mask is a finite -1e30, so its online softmax gives each
such row p = 1 on every key: the plain mean of v over all Sk keys, which
these rows get (in f32, cast to q's dtype). Rows n0.. keep keys
0..q_offset + i, the offset-0 problem on ``q[:, n0:]``, which K6 and K7
(or their plain versions) take at offset 0. The backward is the true
gradient of that forward: the key-less rows add sum(dO) / Sk to dv and
nothing to dq or dk. The reference's own ``_flash_core_bwd`` does not:
its lse there is exactly -1e30 (log Sk is lost in f32), so its p =
exp(s - lse) is 1, not 1 / Sk, and K7's recomputing form would repeat
that, which is why the kernel-level entries refuse a negative offset.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as REF


def split_rows(Sq: int, causal: bool, q_offset) -> tuple:
    """(n0, the offset of rows n0..): under the causal mask and a negative
    offset the first n0 = min(-q_offset, Sq) rows keep no key and the
    rest are at offset 0; otherwise n0 = 0 and the offset is kept (0
    without the mask, which ignores it at any sign)."""
    q_offset = operator.index(q_offset)
    if not causal:
        return 0, 0
    if q_offset >= 0:
        return 0, q_offset
    return min(-q_offset, Sq), 0


def keyless_rows(v, group: int, n0: int, dtype) -> torch.Tensor:
    """(BHkv * group, n0, Dv): each kv head's mean of v over all its keys,
    accumulated in f32 (f64 for f64 inputs) and cast to ``dtype``, for
    each of its ``group`` query heads."""
    m = v.to(REF._acc(v.dtype)).mean(1).to(dtype)           # (BHkv, Dv)
    return m.repeat_interleave(group, 0)[:, None].expand(-1, n0, -1)


def _split_forward(q, k, v, group, causal, scale, backend, q_offset,
                   with_lse):
    """(o, q1, o1, lse, n0, off): the output at any offset; rows n0.. as
    ``q1`` = q[:, n0:] and their output ``o1`` (with ``with_lse`` their
    logsumexp ``lse``, else None), from K6 or its plain version at offset
    ``off`` >= 0, or empty when n0 = Sq; rows ..n0 the key-less means."""
    BH, Sq, _ = q.shape
    n0, off = split_rows(Sq, causal, q_offset)
    q1 = q[:, n0:].contiguous() if n0 else q
    if n0 == Sq:
        o1, lse = q.new_empty(BH, 0, v.shape[2]), None
    else:
        kw = dict(group=group, causal=causal, scale=scale, q_offset=off)
        if dispatch.use_kernel(q, backend):
            out = K.flash_attention_cuda(q1, k, v, with_lse=with_lse, **kw)
        elif with_lse:
            out = REF.flash_attention_lse_ref(q1, k, v, **kw)
        else:
            out = REF.flash_attention_ref(q1, k, v, **kw)
        o1, lse = out if with_lse else (out, None)
    o = (torch.cat([keyless_rows(v, group, n0, q.dtype), o1], dim=1) if n0
         else o1)
    return o, q1, o1, lse, n0, off


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: K6 forward and K7 backward on CUDA
    tensors, the plain versions on CPU tensors or under
    ``backend="ref"``; at a negative offset the key-less rows split off
    as the module's docstring says."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, backend, q_offset):
        o, q1, o1, lse, n0, off = _split_forward(q, k, v, group, causal,
                                                 scale, backend, q_offset,
                                                 True)
        ctx.save_for_backward(q1, k, v, o1, lse)
        ctx.args = (group, causal, scale, backend, off, n0)
        return o

    @staticmethod
    def backward(ctx, do):
        q1, k, v, o1, lse = ctx.saved_tensors
        group, causal, scale, backend, off, n0 = ctx.args
        if q1.shape[1]:
            fn = (BK.flash_attention_bwd_cuda
                  if dispatch.use_kernel(q1, backend)
                  else REF.flash_attention_bwd_ref)
            dq, dk, dv = fn(q1, k, v, o1, lse, do[:, n0:].contiguous(),
                            group=group, causal=causal, scale=scale,
                            q_offset=off)
        else:
            dq, dk, dv = q1, torch.zeros_like(k), torch.zeros_like(v)
        if n0:
            # o_i = mean_j v_j on the key-less rows: d v_j += sum_i dO_i /
            # Sk over the rows and the kv head's query heads
            acc = REF._acc(v.dtype)
            BHkv, Sk, Dv = v.shape
            dsum = do[:, :n0].to(acc).sum(1).reshape(BHkv, group, Dv).sum(1)
            dv = (dv.to(acc) + (dsum / Sk)[:, None]).to(v.dtype)
            dq = torch.cat([dq.new_zeros(dq.shape[0], n0, dq.shape[2]), dq],
                           dim=1)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, group: int = 1, causal: bool = True,
                    scale=None, backend=None, q_offset: int = 0
                    ) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (BH, Sq, Dv); query
    head ``bh`` reads kv head ``bh // group``; under the causal mask query
    row i keeps keys 0..q_offset + i, at any integer offset (a row that
    keeps no key gets the mean of v over all keys, as the reference's
    finite mask gives it; see the module's docstring). Kernel on CUDA
    tensors, plain version on CPU tensors or under ``backend="ref"``; with
    a gradient (:class:`FlashAttention`) when an input requires one."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, group, causal, scale, backend,
                                    q_offset)
    return _split_forward(q, k, v, group, causal, scale, backend, q_offset,
                          False)[0]
