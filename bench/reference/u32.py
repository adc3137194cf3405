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
"""
from __future__ import annotations

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
