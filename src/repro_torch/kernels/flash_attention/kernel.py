"""Binding of the CUDA kernel ``flash_attention`` (csrc/flash_attention.cu).

The C entry holds two kernels. :func:`variant` chooses between them from
the dtype and head dims alone, before anything is built or launched, and
the entry refuses a ``"wgmma"`` launch that breaks the same rule.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_args, ptr, stream_ptr

# D and Dv up to this (kMaxHeadDim in csrc/flash_attention.cu); the Pallas
# function takes any head dim, and no config in the repo has one above it
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1}
# (D, Dv) of the tensor-core instances in bf16: granite's, zamba2's, the
# larger families' and MLA's (the C entries' tensor_cores test holds the
# same)
WGMMA_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
# the kinds ``KERNEL.launches_by_kind`` counts (K7's counter too): a
# causal (top-left) mask or none
MASK_KINDS = ("causal", "full")


def mask_kind(causal: bool) -> str:
    """The launch-count kind of a launch with this ``causal`` flag."""
    return MASK_KINDS[0] if causal else MASK_KINDS[1]

KERNEL = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention/kernel.py:65",
    device_fns=("flash_attention_kernel", "flash_attention_wgmma_kernel"),
    variants=tuple(VARIANTS), kinds=MASK_KINDS)


def variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The kernel that runs for these inputs: ``"wgmma"`` (tensor cores)
    for bf16 with (D, Dv) in :data:`WGMMA_HEAD_DIMS` (zamba2's 80 and
    MLA's D = 192, Dv = 128 among them); ``"simt"`` for every other bf16
    head dim and for f32, whose 2e-5 contract TF32 would break. Raises
    ValueError for another dtype or a head dim outside 1..MAX_HEAD_DIM."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{dtype}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes 1.."
                         f"{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and (D, Dv) in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         scale=None, force_variant=None, with_lse=False):
    """Same contract as ``ref.flash_attention_ref``; f32 or bf16, head
    dims up to :data:`MAX_HEAD_DIM` (D != Dv allowed), any Sq and Sk. The kernel is :func:`variant`'s;
    ``force_variant="simt"`` runs the SIMT kernel on any inputs (to time
    it beside the tensor-core one), and a ``"wgmma"`` the inputs do not
    qualify for raises. ``with_lse``: also return each row's logsumexp
    (BH, Sq) f32, as ``ref.flash_attention_lse_ref`` (the training
    forward keeps it for the backward); without it the kernel writes
    none."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = k.shape[0], k.shape[1], v.shape[2]
    chosen = variant(q.dtype, D, Dv)
    if force_variant is not None:
        if force_variant not in VARIANTS:
            raise ValueError(f"unknown variant {force_variant!r}; expected "
                             f"one of {list(VARIANTS)}")
        if force_variant == "wgmma" and chosen != "wgmma":
            raise ValueError(f"the wgmma kernel takes bf16 with (D, Dv) in "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype} D={D} "
                             f"Dv={Dv}")
        chosen = force_variant
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"q has {BH} heads; k/v have {BHkv} with group "
                         f"{group}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    dev = q.device
    check_args(dev, (("q", q, q.dtype, (BH, Sq, D)),
                     ("k", k, q.dtype, (BHkv, Sk, D)),
                     ("v", v, q.dtype, (BHkv, Sk, Dv))))
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty(BH, Sq, Dv, dtype=q.dtype, device=dev)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=dev) if with_lse
           else None)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out),
                  ctypes.c_void_p(None if lse is None else lse.data_ptr()),
                  BH, group, Sq, Sk, D, Dv, scale, int(causal),
                  DTYPES[q.dtype], VARIANTS[chosen], stream_ptr(dev),
                  variant=chosen, kind=mask_kind(causal))
    return (out, lse) if with_lse else out
