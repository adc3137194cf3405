"""DFA Reporter — line-rate per-flow feature extraction (paper §III-A/IV-A).

Per flow slot: seven 32-bit Table-I registers, the last packet timestamp,
the report-interval register and the stored five-tuple of the
device-resident admission table (stored-key collision detection). Every
u32 tensor is an int32 bit pattern at rest (``repro_torch.u32``).

``ingest`` routes through the ingest_update family: ``backend="ref"``
keeps the multipass shape (hash -> admit -> resolve_iat -> event_deltas
-> scatter-accumulate) as the oracle; otherwise the fused sort-once path
runs, whose segment sums are the CUDA kernel on the card and its plain
version on the CPU. An explicit ``accumulate_fn`` (the flow_moments
family) runs the multipass shape with that accumulator. All are bitwise
equal.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import logstar as LS
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE

N_REG = 7          # Table-I registers: count, IAT, IAT^2, IAT^3, PS, PS^2, PS^3


class ReporterState(NamedTuple):
    regs: torch.Tensor         # (F, 7) u32 — Table-I stat registers
    last_ts: torch.Tensor      # (F,) u32 — last packet timestamp (us)
    last_report: torch.Tensor  # (F,) u32 — report-interval register
    keys: torch.Tensor         # (F, 5) u32 — stored five-tuple
    active: torch.Tensor       # (F,) bool — slot occupied
    seq: torch.Tensor          # () u32 — per-reporter sequence counter
    collisions: torch.Tensor   # () u32 — hash-collision telemetry


def init_state(cfg: DFAConfig, device=None) -> ReporterState:
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


def admit_arrays(keys, active, collisions, slots, five_tuple, valid
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-slot admission with stored-key collision detection.

    A valid event matches the stored key, installs into an empty slot, or
    collides (counted; the event is attributed to the resident flow).
    Within a block the FIRST arrival among new flows hashing to one empty
    slot installs (a scatter-min over arrival index); later arrivals
    compare against the installed key."""
    F = keys.shape[0]
    E = slots.shape[0]
    dev = slots.device
    cl = torch.clamp(slots, 0, F - 1)
    stored = keys[cl]
    empty = ~active[cl]
    match = torch.all(stored == five_tuple, dim=-1) & ~empty
    want = valid & empty
    cand = torch.where(want, slots, torch.full_like(slots, F))
    idx = torch.arange(E, device=dev)
    first_idx = torch.full((F + 1,), E, dtype=torch.int64, device=dev)
    first_idx.scatter_reduce_(0, cand, idx, "amin")
    winner = want & (first_idx[cl] == idx)
    tgt = torch.where(winner, slots, torch.full_like(slots, F))
    new_keys = torch.cat([keys, keys.new_zeros(1, 5)])
    new_keys[tgt] = five_tuple.to(torch.int32)      # unique real targets
    new_keys = new_keys[:F]
    new_active = torch.cat([active, active.new_zeros(1)])
    new_active[tgt] = True
    new_active = new_active[:F]
    dup_match = torch.all(new_keys[cl] == five_tuple, dim=-1)
    collide = valid & ((~empty & ~match) | (empty & ~winner & ~dup_match))
    new_coll = U.narrow(U.wide(collisions) + collide.sum())
    return new_keys, new_active, new_coll


def admit(state: ReporterState, slots, five_tuple, valid
          ) -> Tuple[ReporterState, torch.Tensor]:
    """State-level wrapper over :func:`admit_arrays` (semantics there)."""
    keys, active, collisions = admit_arrays(
        state.keys, state.active, state.collisions, slots, five_tuple,
        valid)
    return state._replace(keys=keys, active=active,
                          collisions=collisions), valid


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


def ingest(state: ReporterState, events: Dict[str, torch.Tensor],
           cfg: DFAConfig, accumulate_fn=None,
           backend=None) -> ReporterState:
    """Process one block of packet events.

    events: ts (E,) u32 | size (E,) u32 | five_tuple (E, 5) u32 |
            valid (E,) bool (u32 words as int32 bit patterns).

    Routes through the ingest_update family. An explicit
    ``accumulate_fn(regs, slots, deltas, valid) -> regs`` runs the
    multipass path with that accumulator instead (how the flow_moments
    kernel is driven in place)."""
    slots = hash_slot(events["five_tuple"], cfg.flows_per_shard)
    if accumulate_fn is not None:
        return _ingest_multipass(state, slots, events, cfg, accumulate_fn)
    from repro_torch.kernels.ingest_update.ops import ingest_update
    regs, last_ts, keys, active, collisions = ingest_update(
        state.regs, state.last_ts, state.keys, state.active,
        state.collisions, slots, events["ts"], events["size"],
        events["five_tuple"], events["valid"], cfg, backend=backend)
    return state._replace(regs=regs, last_ts=last_ts, keys=keys,
                          active=active, collisions=collisions)


def _ingest_multipass(state: ReporterState, slots, events, cfg: DFAConfig,
                      accumulate_fn) -> ReporterState:
    """The pre-fusion multipass ingest with a caller-chosen accumulator
    (admit -> resolve_iat -> event_deltas -> accumulate). The deltas are
    narrowed once to int32 bit patterns, the at-rest form every
    accumulator takes."""
    pre_active = state.active      # admissions see themselves as new
    state, valid = admit(state, slots, events["five_tuple"],
                         events["valid"])
    iat, first, new_last = resolve_iat(slots, events["ts"], valid,
                                       state.last_ts, pre_active)
    deltas = U.narrow(event_deltas(iat, events["size"], first, valid,
                                   cfg.logstar_bits))
    regs = accumulate_fn(state.regs, slots, deltas, valid)
    return state._replace(regs=regs, last_ts=new_last)


def due_flows(state: ReporterState, now, cfg: DFAConfig,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flows whose monitoring period elapsed, most overdue first.

    Returns (slots (capacity,) int64, mask (capacity,) bool). The elapsed
    time is u32 subtraction, so it stays right across clock wrap. Ties
    keep the lower slot first (a stable descending sort), as the
    reference's top-k does."""
    now = U.wide(torch.as_tensor(now, device=state.last_report.device))
    elapsed = (now - U.wide(state.last_report)) & U.MASK
    due = state.active & (elapsed >= cfg.monitoring_period_us)
    if cfg.monitoring_period_us == 0:
        score = torch.where(due, elapsed | 1, 0)
    else:
        score = torch.where(due, elapsed, 0)
    F = score.shape[0]
    k = min(capacity, F)
    idx = torch.sort(score, descending=True, stable=True).indices[:k]
    mask = due[idx]
    if k < capacity:
        idx = torch.cat([idx, idx.new_zeros(capacity - k)])
        mask = torch.cat([mask, mask.new_zeros(capacity - k)])
    return idx, mask


def make_reports(state: ReporterState, slots, mask, now, reporter_id: int,
                 shard_flow_base: int, cfg: DFAConfig, flow_ids=None
                 ) -> Tuple[ReporterState, torch.Tensor]:
    """Clone-and-truncate analogue: DTA reports for the given slots.

    Returns (state', reports (R, report_words) int32 bit patterns);
    masked-out rows are zero. Sequence numbers increment per report.
    ``flow_ids`` ((R,) u32 values) replaces the range identity
    ``shard_flow_base + slot``: the 2-D mesh passes the hash-home or
    rendezvous ids of the slots' stored keys."""
    R = slots.shape[0]
    dev = slots.device
    stats = state.regs[slots]
    tuples = state.keys[slots]
    if flow_ids is None:
        flow_ids = (shard_flow_base + slots) & U.MASK
    else:
        flow_ids = U.wide(flow_ids)
    seqs = (U.wide(state.seq) + torch.cumsum(mask.to(torch.int64), 0)
            - 1) & U.MASK
    reports = PROTO.pack_dta_report(
        flow_ids, torch.full((R,), reporter_id, dtype=torch.int64,
                             device=dev),
        seqs, stats, tuples, wire=WIRE.resolve(cfg))
    reports = torch.where(mask[:, None], reports, torch.zeros_like(reports))
    F = state.last_report.shape[0]
    upd = torch.where(mask, slots, torch.full_like(slots, F))
    last_report = torch.cat([state.last_report,
                             state.last_report.new_zeros(1)])
    last_report[upd] = U.narrow(U.wide(torch.as_tensor(now, device=dev)))
    new_seq = U.narrow(U.wide(state.seq) + mask.sum())
    return state._replace(last_report=last_report[:F], seq=new_seq), reports
