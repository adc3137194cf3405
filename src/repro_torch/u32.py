"""u32 words on PyTorch: int32 bit patterns at rest, int64 for arithmetic.

The reference system keeps every register, key, timestamp, ring word and
counter as ``uint32`` with mod-2^32 wraparound (the P4 register
semantics). ``torch.uint32`` cannot carry that: it has no add, shift,
compare, sort or scatter. The port therefore splits the two roles:

* **At rest** (state tensors, reports, payloads, event words) a u32 word
  is a ``torch.int32`` holding the same 32 bits. It occupies the same
  bytes as the reference's ``uint32`` (the PAPER ring stays 84 MB) and a
  CUDA kernel takes it as ``uint32_t*`` with no conversion pass.
* **In arithmetic** (adds, shifts, unsigned compares, sorts by value)
  torch code widens it to ``int64`` in ``[0, 2^32)`` with :func:`wide`,
  computes, and narrows the result back with :func:`narrow`, which keeps
  the low 32 bits — the reference's wraparound.

Crossing to and from numpy ``uint32`` is a bit-level view
(``ndarray.view(np.int32)``), never a value conversion.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_SIGN = 0x80000000


def wide(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or an int64 already in range) -> int64 value in
    [0, 2^32). Idempotent on widened values."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> int32 holding its low 32 bits (mod 2^32)."""
    return (((x.to(torch.int64) & MASK) ^ _SIGN) - _SIGN).to(torch.int32)


def mul(a, b) -> torch.Tensor:
    """u32 product mod 2^32 of two u32 values (int32 bit patterns, widened
    int64 tensors or Python ints), as a widened int64 in [0, 2^32).

    A full product of two u32 values reaches 2^64 and overflows int64, so
    ``b`` is split into 16-bit halves: each partial product stays below
    2^48, and the high half only contributes its low 16 bits << 16."""
    a = wide(a) if isinstance(a, torch.Tensor) else a & MASK
    b = wide(b) if isinstance(b, torch.Tensor) else b & MASK
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy u32 (or anything numpy casts to u32 losslessly) -> int32
    bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern (or widened int64) tensor -> numpy uint32."""
    t = t.detach().cpu()
    if t.dtype == torch.int64:
        return (t & MASK).numpy().astype(np.uint32)
    return t.to(torch.int32).numpy().view(np.uint32)

