"""Binding of the CUDA kernel ``flash_attention_bwd``
(csrc/flash_attention_bwd.cu, K7): the gradient of K6's attention.

The C entry holds three designs, named by :func:`variant`: ``"fused"``
(tensor cores, bf16 with (D, Dv) in :data:`FUSED_HEAD_DIMS`: dQ summed
inside the dK, dV kernel in a fixed order), ``"wgmma"`` (tensor cores,
the three-kernel design with a dQ kernel of its own: bf16 at zamba2's
(80, 80) and MLA's (192, 128), the rest of K6's ``WGMMA_HEAD_DIMS``) and
``"simt"`` (f32 FMAs, every other input). ``force_variant`` runs
``"simt"`` on any inputs and ``"wgmma"`` on any of K6's tensor-core
head dims (the three-kernel design at (64, 64) and (128, 128) too); the
entry refuses a launch that breaks the rule.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_args, ptr, stream_ptr
from repro_torch.kernels.flash_attention import kernel as K6
from repro_torch.kernels.flash_attention.kernel import (DTYPES, MASK_KINDS,
                                                        WGMMA_HEAD_DIMS,
                                                        mask_kind)
from repro_torch.kernels.flash_attention.ref import check_q_offset

# K7's head-dim limit (kMaxHeadDim in csrc/flash_attention_bwd.cu), K6's:
# the SIMT kernels take D and Dv up to 256 (MLA's 192 / 128 among them)
MAX_HEAD_DIM = 256

# the tensor-core designs' scratch holds each head's rows padded to a
# multiple of this (kRowPad in csrc/flash_attention_bwd.cu), which every
# query tile of their kernels divides
ROW_PAD = 128
# the fused design's query tile (kDkdvBQ): one dQ counter per tile
FUSED_Q_TILE = 64

# the C entry's variant numbers
VARIANTS = {"simt": 0, "wgmma": 1, "fused": 2}
# (D, Dv) of the fused design in bf16: granite's, whisper's and llama4's /
# llava's (the C entry's fused test holds the same)
FUSED_HEAD_DIMS = ((64, 64), (128, 128))

KERNEL = CudaKernel(
    "flash_attention_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="src/repro/models/attention.py:146",
    device_fns=("attn_bwd_dsum_kernel", "attn_bwd_dkdv_kernel",
                "attn_bwd_dq_kernel", "attn_bwd_prep_kernel",
                "attn_bwd_dkdv_wgmma_kernel", "attn_bwd_dq_wgmma_kernel",
                "attn_bwd_fused_wgmma_kernel", "attn_bwd_dq_convert_kernel"),
    variants=tuple(VARIANTS), kinds=MASK_KINDS)


def variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The design that runs for these inputs: ``"fused"`` where K6's rule
    (:func:`kernel.variant`) names its tensor cores and (D, Dv) is in
    :data:`FUSED_HEAD_DIMS`, ``"wgmma"`` (the three-kernel design) at
    K6's other tensor-core head dims, else ``"simt"``. Raises as K6's
    rule does."""
    if K6.variant(dtype, D, Dv) == "simt":
        return "simt"
    return "fused" if (D, Dv) in FUSED_HEAD_DIMS else "wgmma"


def scratch_numel(chosen: str, BH: int, Sq: int, D: int = 0) -> int:
    """f32 elements of the scratch a launch of variant ``chosen`` needs:
    Dsum (BH, Sq) for simt; lse * log2 e and Dsum (2, BH, Sp) for wgmma,
    each head's rows padded to Sp, a multiple of :data:`ROW_PAD`; for
    fused those, dQ's f32 accumulator (BH, Sp, D) and one int32 counter
    per (head, query tile of :data:`FUSED_Q_TILE` rows) plus the blocks'
    ticket."""
    if chosen == "simt":
        return BH * Sq
    Sp = -(-Sq // ROW_PAD) * ROW_PAD
    if chosen == "wgmma":
        return 2 * BH * Sp
    return 2 * BH * Sp + BH * Sp * D + BH * (Sp // FUSED_Q_TILE) + 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, group: int = 1,
                             causal: bool = True, scale=None,
                             force_variant=None, q_offset: int = 0):
    """Same contract as ``ref.flash_attention_bwd_ref``: q, o, do (BH, Sq,
    D|Dv) and k, v (BH // group, Sk, D|Dv) in f32 or bf16, lse (BH, Sq)
    f32 from K6 -> (dq, dk, dv) in the inputs' dtype. Head dims up to
    :data:`MAX_HEAD_DIM` (D != Dv allowed), any Sq and Sk, and K6's
    causal mask at query offset ``q_offset`` >= 0 (every design takes
    it; a negative offset raises ValueError: at a key-less row p = exp(s
    - lse) is not the forward's softmax, as ``ref.check_q_offset`` says,
    and ``ops.FlashAttention`` takes those rows' gradient itself). One call
    launches the chosen design's three kernels: :func:`variant`'s, or
    under ``force_variant`` the SIMT ones (``"simt"``) or the three-kernel
    tensor-core ones (``"wgmma"``, also where the rule names ``"fused"``),
    to time them beside it; a forced variant the inputs do not qualify
    for raises, and nothing falls back."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = v.shape
    chosen = variant(q.dtype, D, Dv)
    if force_variant is not None:
        if force_variant not in VARIANTS:
            raise ValueError(f"unknown variant {force_variant!r}; expected "
                             f"one of {list(VARIANTS)}")
        if force_variant == "wgmma" and chosen not in ("wgmma", "fused"):
            raise ValueError(f"the wgmma kernels take bf16 with (D, Dv) in "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype} D={D} "
                             f"Dv={Dv}")
        if force_variant == "fused" and chosen != "fused":
            raise ValueError(f"the fused kernels take bf16 with (D, Dv) in "
                             f"{FUSED_HEAD_DIMS}, got {q.dtype} D={D} "
                             f"Dv={Dv}")
        chosen = force_variant
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes 1.."
                         f"{MAX_HEAD_DIM}")
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"q has {BH} heads; k/v have {BHkv} with group "
                         f"{group}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    q_offset = check_q_offset(q_offset)
    q_offset = min(q_offset, Sk) if causal else 0
    dev = q.device
    dt = q.dtype
    check_args(dev, (("q", q, dt, (BH, Sq, D)), ("k", k, dt, (BHkv, Sk, D)),
                     ("v", v, dt, (BHkv, Sk, Dv)), ("o", o, dt, (BH, Sq, Dv)),
                     ("do", do, dt, (BH, Sq, Dv)),
                     ("lse", lse, torch.float32, (BH, Sq))))
    scale = D ** -0.5 if scale is None else float(scale)
    scratch = torch.empty(scratch_numel(chosen, BH, Sq, D),
                          dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                  ptr(scratch), ptr(dq), ptr(dk), ptr(dv), BH, group, Sq, Sk,
                  D, Dv, scale, int(causal), q_offset, DTYPES[dt],
                  VARIANTS[chosen], stream_ptr(dev), variant=chosen,
                  kind=mask_kind(causal))
    return dq, dk, dv
