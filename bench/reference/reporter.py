"""DFA Reporter — line-rate per-flow feature extraction (paper §III-A/IV-A).

Per flow slot: seven 32-bit Table-I registers, the last packet timestamp,
the report-interval register and the stored five-tuple of the
device-resident admission table (stored-key collision detection). Every
u32 tensor is an int32 bit pattern at rest (``u32``).

Here: the state, the FNV-1a slot hash, IAT resolution by one stable
sort, the Table-I deltas and the scatter-accumulate; :mod:`ports`
builds the period's ingest, due-flow selection and reports on them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import u32 as U
from . import logstar as LS

N_REG = 7          # Table-I registers: count, IAT, IAT^2, IAT^3, PS, PS^2, PS^3


class ReporterState(NamedTuple):
    regs: torch.Tensor         # (F, 7) u32 — Table-I stat registers
    last_ts: torch.Tensor      # (F,) u32 — last packet timestamp (us)
    last_report: torch.Tensor  # (F,) u32 — report-interval register
    keys: torch.Tensor         # (F, 5) u32 — stored five-tuple
    active: torch.Tensor       # (F,) bool — slot occupied
    seq: torch.Tensor          # () u32 — per-reporter sequence counter
    collisions: torch.Tensor   # () u32 — hash-collision telemetry


def init_state(cfg, device=None) -> ReporterState:
    F = cfg.flows_per_shard

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return ReporterState(regs=z(F, N_REG), last_ts=z(F), last_report=z(F),
                         keys=z(F, 5),
                         active=torch.zeros(F, dtype=torch.bool,
                                            device=device),
                         seq=z(), collisions=z())


def hash_u32(five_tuple: torch.Tensor) -> torch.Tensor:
    """Raw FNV-1a u32 hash of the 5 identity words (widened int64)."""
    w = U.wide(five_tuple)
    h = torch.full(w.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                   device=w.device)
    for i in range(5):
        h = ((h ^ w[..., i]) * 0x01000193) & U.MASK
    return h


def hash_slot(five_tuple: torch.Tensor, n_slots: int) -> torch.Tensor:
    """FNV-1a hash of the 5 identity words -> slot index (int64)."""
    h = hash_u32(five_tuple)
    if n_slots & (n_slots - 1) == 0:
        return h & (n_slots - 1)
    return h % n_slots


def event_deltas(iat, ps, first, valid, bits: int) -> torch.Tensor:
    """Per-event Table-I register deltas (E, 7), widened u32 values."""
    iat = torch.where(first, torch.zeros_like(U.wide(iat)), U.wide(iat))
    ps = U.wide(ps)
    d = torch.stack([torch.ones_like(ps), iat,
                     LS.approx_pow(iat, 2, bits), LS.approx_pow(iat, 3, bits),
                     ps, LS.approx_pow(ps, 2, bits),
                     LS.approx_pow(ps, 3, bits)], dim=-1)
    return torch.where(valid[..., None], d, torch.zeros_like(d))


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """[fill, x[0], ..., x[-2]] along dim 0."""
    head = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([head, x[:-1]])


def resolve_iat(slots, ts, valid, last_ts, active
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-event (iat, first_flag, new_last_ts).

    A stable sort by slot keeps arrival order inside each slot's run, so
    an event's predecessor is the previous run member or the register.
    The new last_ts of a slot is its run's LAST event in arrival order —
    the wrap-safe update (the u32 µs clock wraps every ~71.6 min)."""
    F = last_ts.shape[0]
    safe = torch.where(valid, slots, torch.full_like(slots, F))
    order = torch.sort(safe, stable=True).indices
    s_slot = safe[order]
    s_ts = U.wide(ts)[order]
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool,
                                       device=slots.device),
                           s_slot[1:] == s_slot[:-1]])
    cl = torch.clamp(s_slot, 0, F - 1)
    real = s_slot < F
    reg_last = torch.where(real, U.wide(last_ts)[cl], 0)
    reg_active = real & active[cl]
    prev_ts = torch.where(prev_same, _shift_right(s_ts, 0), reg_last)
    first = torch.where(prev_same, torch.zeros_like(prev_same), ~reg_active)
    iat_sorted = (s_ts - prev_ts) & U.MASK
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    run_tail = torch.cat([s_slot[1:] != s_slot[:-1],
                          torch.ones(1, dtype=torch.bool,
                                     device=slots.device)])
    upd = torch.where(run_tail & real, s_slot, torch.full_like(s_slot, F))
    new_last = torch.cat([last_ts, last_ts.new_zeros(1)])
    new_last[upd] = U.narrow(s_ts)        # unique per real slot
    return iat_sorted[inv], first[inv], new_last[:F]


def accumulate_ref(regs, slots, deltas, valid) -> torch.Tensor:
    """Oracle scatter-accumulate (u32 wraparound): (F, 7) registers plus
    each valid event's (7,) deltas at its slot; deltas as int32 bit
    patterns or widened values, slots outside [0, F) dropped."""
    F = regs.shape[0]
    keep = valid & (slots >= 0) & (slots < F)
    idx = torch.where(keep, slots, torch.full_like(slots, F))
    acc = torch.cat([U.wide(regs), regs.new_zeros(1, regs.shape[1],
                                                  dtype=torch.int64)])
    acc.index_add_(0, idx, U.wide(deltas))
    return U.narrow(acc[:F])
