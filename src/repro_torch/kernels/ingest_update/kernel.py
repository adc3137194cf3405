"""ingest_update — fused sort-once reporter ingest: the torch-op stages
around the CUDA kernel ``ingest_segment_sums`` and its binding.

One stable sort by slot makes each slot's events one contiguous,
arrival-ordered run; everything else is one pass over the sorted stream:

* :func:`stream_prep` — the sort plus the O(E) run-boundary resolution:
  IAT predecessors (run head reads the last_ts register, everyone else
  the previous run member), first-packet flags, admission (the run head
  is the first-come installer) and collisions;
* the kernel (``csrc/ingest_segment_sums.cu``) forms the seven Table-I
  deltas inline and reduces them into per-tile run-prefix sums;
* :func:`apply_updates` — one scatter-add per (tile-cut) run plus the
  last_ts / keys / active scatter-sets.

Stream tensors are int32 bit patterns; pad rows (up to a multiple of the
tile) ride the sentinel slot F and are dropped by the scatters.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.core import logstar as LS
from repro_torch.kernels.build import CudaKernel, ptr, stream_ptr

N_REG = 7
REG_PAD = 8              # 7 deltas + a zero column (the TPU contract)
MAX_EVENT_TILE = 256     # tile cuts stay those of the TPU kernels

KERNEL = CudaKernel(
    "ingest_segment_sums",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/ingest_update/kernel.py:207",
    device_fns=("segment_sums_kernel",))


def clamp_tile(event_tile: int, events: int) -> int:
    """Largest legal tile: <= 256, <= the block size, >= 1."""
    return max(1, min(int(event_tile), MAX_EVENT_TILE, int(events)))


class SortedStream(NamedTuple):
    s_slot: torch.Tensor    # (Ep,) i32 — slot, F = invalid/pad sentinel
    s_ts: torch.Tensor      # (Ep,) u32 — timestamps (arrival order per run)
    s_ps: torch.Tensor      # (Ep,) u32 — packet sizes
    s_key: torch.Tensor     # (Ep, 5) u32 — five-tuples
    base_ts: torch.Tensor   # (Ep,) u32 — IAT predecessor timestamp
    first: torch.Tensor     # (Ep,) bool — first packet of a new flow
    run_tail: torch.Tensor  # (Ep,) bool — last event of its slot run
    install: torch.Tensor   # (Ep,) bool — run head claiming an empty slot
    collide: torch.Tensor   # (Ep,) bool — key mismatch vs resident/installed
    tile: int               # event tile


def stream_prep(last_ts, keys, active, slots, ts, ps, five_tuple, valid,
                event_tile: int) -> SortedStream:
    """The one stable sort plus run-boundary / admission resolution."""
    F = last_ts.shape[0]
    E = slots.shape[0]
    dev = slots.device
    tile = clamp_tile(event_tile, E)
    pad = (-E) % tile
    safe = torch.where(valid, slots, torch.full_like(slots, F))
    order = torch.sort(safe, stable=True).indices

    def srt(a, c=0):
        out = a[order]
        if pad:
            out = torch.cat([out, torch.full((pad,) + tuple(a.shape[1:]), c,
                                             dtype=a.dtype, device=dev)])
        return out

    s_slot = srt(safe, F).to(torch.int32)
    s_ts = srt(ts.to(torch.int32))
    s_ps = srt(ps.to(torch.int32))
    s_key = srt(five_tuple.to(torch.int32))
    Ep = s_slot.shape[0]
    real = s_slot < F
    cl = torch.clamp(s_slot, 0, F - 1).to(torch.int64)
    reg_last = last_ts[cl]
    reg_active = real & active[cl]
    reg_key = keys[cl]
    change = s_slot[1:] != s_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    run_head = torch.cat([one, change])
    run_tail = torch.cat([change, one])
    prev_ts = torch.cat([s_ts.new_zeros(1), s_ts[:-1]])
    base_ts = torch.where(run_head, reg_last, prev_ts)
    first = run_head & ~reg_active
    # s_slot is sorted, so a row's run head is the first row holding its
    # slot: a binary search per row (a cummax over the run-head flags
    # gives the same index but is an order of magnitude slower on CUDA)
    head_idx = torch.searchsorted(s_slot, s_slot, side="left")
    eff_key = torch.where(reg_active[:, None], reg_key, s_key[head_idx])
    match = torch.all(s_key == eff_key, dim=-1)
    install = run_head & ~reg_active & real
    collide = real & ~match & ~install
    return SortedStream(s_slot, s_ts, s_ps, s_key, base_ts, first, run_tail,
                        install, collide, tile)


def apply_updates(regs, last_ts, keys, active, collisions, st: SortedStream,
                  run_sums, sum_rows
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """One scatter-add per run segment (``sum_rows`` marks the rows of
    ``run_sums`` carrying a segment sum) plus the per-slot last_ts / keys
    / active scatter-sets.

    Rows that carry nothing are spread over 64 discard rows past the end
    of the register table instead of one sentinel row, so a 2^20-event
    block does not serialise a million atomic adds on one address."""
    F = regs.shape[0]
    dev = regs.device
    real = st.s_slot < F
    slot = st.s_slot.to(torch.int64)
    Ep = slot.shape[0]
    discard = F + (torch.arange(Ep, device=dev) & 63)
    upd = torch.where(sum_rows & real, slot, discard)
    acc = torch.cat([U.wide(regs), torch.zeros(64, N_REG, dtype=torch.int64,
                                               device=dev)])
    acc.index_add_(0, upd, U.wide(run_sums[:, :N_REG]))
    regs = U.narrow(acc[:F])
    sentinel = torch.full_like(slot, F)
    tail = torch.where(st.run_tail & real, slot, sentinel)
    new_last = torch.cat([last_ts, last_ts.new_zeros(1)])
    new_last[tail] = st.s_ts
    inst = torch.where(st.install, slot, sentinel)
    new_keys = torch.cat([keys, keys.new_zeros(1, 5)])
    new_keys[inst] = st.s_key
    new_active = torch.cat([active, active.new_zeros(1)])
    new_active[inst] = True
    collisions = U.narrow(U.wide(collisions) + st.collide.sum())
    return regs, new_last[:F], new_keys[:F], new_active[:F], collisions


def delta_cols(iat, ps, bits: int, log_lut, exp_lut):
    """The seven Table-I delta columns (iat already zeroed for firsts)."""
    def pw(x, n):
        return LS.approx_pow_with_luts(x, n, bits, log_lut, exp_lut)

    return (torch.ones_like(ps), iat, pw(iat, 2), pw(iat, 3),
            ps, pw(ps, 2), pw(ps, 3))


def segment_sums_cuda(s_slot, s_ts, s_ps, base_ts, first_i32, log_lut,
                      exp_lut, *, bits: int, tile: int) -> torch.Tensor:
    """Launch ``ingest_segment_sums`` -> (Ep, 8) int32 bit patterns."""
    Ep = s_slot.shape[0]
    n_lut = 1 << bits
    for name, t in (("s_slot", s_slot), ("s_ts", s_ts), ("s_ps", s_ps),
                    ("base_ts", base_ts), ("first", first_i32)):
        if (not t.is_cuda or t.dtype != torch.int32 or t.shape != (Ep,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous ({Ep},) int32 "
                             f"CUDA tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    for name, t in (("log_lut", log_lut), ("exp_lut", exp_lut)):
        if (t.device != s_slot.device or t.dtype != torch.int32
                or t.shape != (n_lut,) or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous ({n_lut},) int32 "
                             f"tensor on {s_slot.device}")
    if Ep % tile or not 1 <= tile <= MAX_EVENT_TILE or not 1 <= bits <= 12:
        raise ValueError(f"bad geometry: Ep={Ep} tile={tile} bits={bits}")
    out = torch.empty(Ep, REG_PAD, dtype=torch.int32, device=s_slot.device)
    KERNEL.launch(ptr(s_slot), ptr(s_ts), ptr(s_ps), ptr(base_ts),
                  ptr(first_i32), ptr(log_lut), ptr(exp_lut), ptr(out),
                  Ep, tile, bits, stream_ptr(s_slot.device))
    return out
