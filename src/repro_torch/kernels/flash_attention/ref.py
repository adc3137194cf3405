"""Plain PyTorch versions of flash_attention and of its gradient:
masked softmax attention over the flattened (BH, S, D) layout with the
scores materialised (the port of ``repro.kernels.flash_attention.ref``),
the forward with its per-row logsumexp, and the recomputing backward of
the reference's ``_flash_core_bwd`` (``repro.models.attention``).

The causal mask is the reference's ``chunked_attention``'s: query row i
sits at position ``q_offset + i`` and keeps key j when j <= q_offset + i,
keys counting from 0 (``q_offset`` = 0: the TPU kernel's top-left mask;
an offset >= Sk - 1 keeps every key). A negative offset raises here, as
in K6 and K7: ``ops.flash_attention`` splits off the rows that would keep
no key before it calls any of them.

Arithmetic is in f32 for f32 and bf16 inputs (in f64 for f64 inputs,
which only the gradient checks use)."""
from __future__ import annotations

import operator

import torch

NEG_INF = -1e30


def check_q_offset(q_offset) -> int:
    """``q_offset`` as an int; ValueError if it is negative. The
    kernel-level entries (K6, K7 and these plain versions) take offsets
    >= 0 only: the TPU kernel ``flash_attention_pallas`` has no offset,
    and at a row that keeps no key the lse is the mask's -1e30 (log Sk is
    lost in f32), so the backward's p = exp(s - lse) would be 1 on every
    key where the forward's is 1 / Sk: the reference's ``_flash_core_bwd``
    makes that error, and this form would copy it. ``ops.flash_attention``
    gives such rows the mean of v and its true gradient instead."""
    q_offset = operator.index(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset}: the query offset must be "
                         f">= 0")
    return q_offset


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, group: int, causal: bool, scale, q_offset: int = 0):
    """f32 (BH, Sq, Sk) scaled scores, masked to -1e30 (causal: query i
    sees keys 0..q_offset + i); the head dim's default scale."""
    q_offset = check_q_offset(q_offset)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    acc = _acc(q.dtype)
    scale = D ** -0.5 if scale is None else scale
    kk = k[torch.arange(BH, device=q.device) // group]     # (BH, Sk, D)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), kk.to(acc)) * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=q_offset)
        s = torch.where(mask[None], s, NEG_INF)
    return s, scale


def flash_attention_lse_ref(q, k, v, *, group: int = 1, causal: bool = True,
                            scale=None, q_offset: int = 0):
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (out (BH, Sq, Dv)
    in q's dtype, lse (BH, Sq) f32: each row's logsumexp of the scaled
    scores, natural log). Scores and the p·v product accumulate in f32;
    the normalised softmax p is rounded to v's dtype before p·v. K6, the
    TPU kernel and the reference's model path round the unnormalised
    exp(s - m) instead and divide by the row sum at the end; in bf16 the
    two differ by rounding only, and the port's whole bf16 attention (this
    forward, then :func:`flash_attention_bwd_ref`) holds the x1.5 rule
    against the reference's bf16 forward and VJP
    (``tests/test_torch_flash_bwd.py``)."""
    s, _ = _scores(q, k, group, causal, scale, q_offset)
    vv = v[torch.arange(q.shape[0], device=q.device) // group]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bke->bqe", p.to(v.dtype).to(s.dtype),
                       vv.to(s.dtype)).to(q.dtype)
    return out, lse.to(torch.promote_types(lse.dtype, torch.float32))


def flash_attention_ref(q, k, v, *, group: int = 1, causal: bool = True,
                        scale=None, q_offset: int = 0):
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (BH, Sq, Dv) in
    q's dtype (see :func:`flash_attention_lse_ref`)."""
    return flash_attention_lse_ref(q, k, v, group=group, causal=causal,
                                   scale=scale, q_offset=q_offset)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, group: int = 1,
                            causal: bool = True, scale=None,
                            q_offset: int = 0):
    """The gradient of :func:`flash_attention_ref` given the forward's
    output ``o`` and logsumexp ``lse`` (BH, Sq) and the output's gradient
    ``do`` (BH, Sq, Dv) -> (dq, dk, dv) in the inputs' dtypes, computed in
    f32 as the reference's ``_flash_core_bwd``:

        Dsum = rowsum(do * o),  p = exp(s - lse),  dv = p^T do,
        dp = do v^T,  ds = p * (dp - Dsum) * scale,  dq = ds k,
        dk = ds^T q,

    with dk and dv summed over each kv head's ``group`` query heads."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = v.shape
    s, scale = _scores(q, k, group, causal, scale, q_offset)
    acc = s.dtype
    kv_idx = torch.arange(BH, device=q.device) // group
    do_, o_ = do.to(acc), o.to(acc)
    dsum = (do_ * o_).sum(-1)                                 # (BH, Sq)
    p = torch.exp(s - lse.to(acc)[..., None])
    dv = torch.einsum("bqk,bqe->bke", p, do_)
    dp = torch.einsum("bqe,bke->bqk", do_, v[kv_idx].to(acc))
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k[kv_idx].to(acc))
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(acc))
    dk = dk.reshape(BHkv, group, Sk, D).sum(1)
    dv = dv.reshape(BHkv, group, Sk, Dv).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
