"""log* — the paper's lookup-table logarithm (Table I), in torch ops.

x^n is approximated as exp*(n * log*(x)): log2 in Q16 fixed point with
the mantissa refined through a 2^bits-entry LUT, exp2 through the
inverse LUT, saturating at 2^32 - 1. Inputs and outputs are widened u32
values (int64 in [0, 2^32), see ``u32``); the LUTs arrive as
int64 tensors so the same functions run on any device. The CUDA ingest
kernel carries the same arithmetic as ``__device__`` functions
(``csrc/ingest_segment_sums.cu``).

The reference computes the exponent with a count-leading-zeros op, which
torch lacks; :func:`bit_length` is the exact stand-in (``frexp`` on
float64, exact for every value below 2^53).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import u32 as U

Q = 16                      # fixed-point fractional bits for log values


@functools.lru_cache(maxsize=None)
def _luts(bits: int):
    """(log_lut, exp_lut) as numpy uint32 arrays.

    log_lut[i] = round(2^Q * log2(1 + i/2^bits)),  i in [0, 2^bits)
    exp_lut[i] = round(2^bits * (2^(i/2^bits) - 1)), i in [0, 2^bits)
    """
    n = 1 << bits
    i = np.arange(n, dtype=np.float64)
    log_lut = np.round((1 << Q) * np.log2(1.0 + i / n)).astype(np.uint32)
    exp_lut = np.round(n * (np.exp2(i / n) - 1.0)).astype(np.uint32)
    return log_lut, exp_lut


def lut_tensors(bits: int, device=None, dtype=torch.int64):
    """Both LUTs as tensors on ``device``, copied there once per (bits,
    device, dtype) and shared by every later call: a pageable host ->
    device copy makes the host wait for the device, so a copy per call
    would stall every period. Callers only read them."""
    return _lut_tensors(bits, torch.device(device or "cpu"), dtype)


@functools.lru_cache(maxsize=None)
def _lut_tensors(bits: int, device: torch.device, dtype):
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device=device,
                                                          dtype=dtype)
                 for t in _luts(bits))


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of each value (0 for 0), int64."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def log2_star_with_lut(x: torch.Tensor, bits: int,
                       lut: torch.Tensor) -> torch.Tensor:
    """u32 -> Q16 fixed-point log2 approximation (0 for x == 0)."""
    x = U.wide(x)
    nbits = bit_length(torch.clamp(x, min=1))
    e = nbits - 1                                          # floor(log2 x)
    shift = torch.clamp(nbits - 1 - bits, min=0)
    frac = (x >> shift) & ((1 << bits) - 1)
    upshift = torch.clamp(bits - (nbits - 1), min=0)
    frac = (frac << upshift) & ((1 << bits) - 1)
    val = ((e << Q) + lut[frac]) & U.MASK
    return torch.where(x == 0, torch.zeros_like(val), val)


def exp2_star_with_lut(l: torch.Tensor, bits: int,
                       lut: torch.Tensor) -> torch.Tensor:
    """Q16 fixed-point log2 -> u32 value (saturating at 2^32 - 1)."""
    l = U.wide(l)
    e = l >> Q                                             # integer part
    frac = (l >> (Q - bits)) & ((1 << bits) - 1)
    mant = (1 << bits) + lut[frac]                     # in [2^b, 2^{b+1})
    sat = e >= 32
    sh = torch.clamp(e - bits, -(bits + 32), 31)
    down = torch.clamp(-sh, 1, 31)
    half = torch.ones_like(down) << (down - 1)
    rounded = (mant + half) >> down                # round on down-shift
    up = (mant << torch.clamp(sh, 0, 31)) & U.MASK    # u32 shift truncates
    val = torch.where(sh >= 0, up, rounded)
    val = torch.where(sat, torch.full_like(val, U.MASK), val)
    return torch.where(l == 0, torch.ones_like(val), val)


def approx_pow_with_luts(x: torch.Tensor, n: int, bits: int,
                         log_lut: torch.Tensor,
                         exp_lut: torch.Tensor) -> torch.Tensor:
    """x^n through the log*/exp* LUT pipeline (saturating u32); 0 -> 0."""
    x = U.wide(x)
    ln = (log2_star_with_lut(x, bits, log_lut) * n) & U.MASK
    sat = (ln >> Q) >= 32
    v = exp2_star_with_lut(ln, bits, exp_lut)
    v = torch.where(sat, torch.full_like(v, U.MASK), v)
    return torch.where(x == 0, torch.zeros_like(v), v)


def approx_pow(x: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    log_lut, exp_lut = lut_tensors(bits, x.device)
    return approx_pow_with_luts(x, n, bits, log_lut, exp_lut)
