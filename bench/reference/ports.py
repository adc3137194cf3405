"""Every port's reporter at once: the P per-port Marina tables as one table
of P * F slots (port p's slot s at p * F + s), the period's events
port-major, the counters per port.

The same operations as :mod:`reporter` (hash-slot admission with
stored-key collision detection, IAT resolution by one stable sort, the
Table-I deltas, a scatter-add), due-flow selection and report emission,
done once for all ports instead of once per port. Slots of different
ports never meet, so each port's result is the one its own table would
give.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import protocol as PROTO
from . import reporter as REP
from . import u32 as U
from . import wire as WIRE


def ingest(state: REP.ReporterState, events, cfg, P: int
           ) -> REP.ReporterState:
    """One period's events (P * E, port-major) into the P tables."""
    F = cfg.flows_per_shard
    N = events["ts"].shape[0]
    E = N // P
    dev = events["ts"].device
    port = torch.arange(N, device=dev) // E
    five, valid = events["five_tuple"], events["valid"]
    slots = port * F + REP.hash_slot(five, F)
    FT = P * F
    # admission: the first arrival among new flows installs, per slot
    cl = torch.clamp(slots, 0, FT - 1)
    empty = ~state.active[cl]
    match = torch.all(state.keys[cl] == five, dim=-1) & ~empty
    want = valid & empty
    idx = torch.arange(N, device=dev)
    first = torch.full((FT + 1,), N, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, torch.where(want, slots, FT), idx, "amin")
    winner = want & (first[cl] == idx)
    tgt = torch.where(winner, slots, FT)
    keys = torch.cat([state.keys, state.keys.new_zeros(1, 5)])
    keys[tgt] = five.to(torch.int32)
    keys = keys[:FT]
    active = torch.cat([state.active, state.active.new_zeros(1)])
    active[tgt] = True
    active = active[:FT]
    dup = torch.all(keys[cl] == five, dim=-1)
    collide = valid & ((~empty & ~match) | (empty & ~winner & ~dup))
    per_port = torch.zeros(P, dtype=torch.int64, device=dev)
    per_port.index_add_(0, port, collide.to(torch.int64))
    collisions = U.narrow(U.wide(state.collisions) + per_port)
    # IAT against the pre-period activity, deltas, scatter-add
    iat, first_pkt, last_ts = REP.resolve_iat(slots, events["ts"], valid,
                                              state.last_ts, state.active)
    deltas = U.narrow(REP.event_deltas(iat, events["size"], first_pkt,
                                       valid, cfg.logstar_bits))
    regs = REP.accumulate_ref(state.regs, slots, deltas, valid)
    return state._replace(regs=regs, last_ts=last_ts, keys=keys,
                          active=active, collisions=collisions)


def due_flows(state: REP.ReporterState, now, cfg, P: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per port, the ``capacity`` most overdue active slots (ties: lower
    slot first) as global slots (P, capacity), and their mask."""
    F = cfg.flows_per_shard
    now = U.wide(torch.as_tensor(now, device=state.last_report.device))
    elapsed = (now - U.wide(state.last_report)) & U.MASK
    due = state.active & (elapsed >= cfg.monitoring_period_us)
    if cfg.monitoring_period_us == 0:
        score = torch.where(due, elapsed | 1, 0)
    else:
        score = torch.where(due, elapsed, 0)
    k = min(capacity, F)
    idx = torch.sort(score.view(P, F), dim=1, descending=True,
                     stable=True).indices[:, :k]
    base = torch.arange(P, device=idx.device)[:, None] * F
    mask = due.view(P, F).gather(1, idx)
    if k < capacity:
        idx = torch.cat([idx, idx.new_zeros(P, capacity - k)], 1)
        mask = torch.cat([mask, mask.new_zeros(P, capacity - k)], 1)
    return idx + base, mask


def make_reports(state: REP.ReporterState, gslots, mask, now, cfg,
                 flow_ids) -> Tuple[REP.ReporterState, torch.Tensor]:
    """DTA reports (P, R, report_words) of the given global slots, port p
    reporting as reporter ``p`` (mod the wire's reporter space);
    ``flow_ids`` (P, R) are the reports' flow identities. Masked-out rows
    are zero; seqs count on per port."""
    P, R = gslots.shape
    dev = gslots.device
    wf = WIRE.resolve(cfg)
    seqs = (U.wide(state.seq)[:, None]
            + torch.cumsum(mask.to(torch.int64), 1) - 1) & U.MASK
    rid = (torch.arange(P, device=dev) % wf.n_reporters)[:, None].expand(
        P, R)
    reports = PROTO.pack_dta_report(
        U.wide(flow_ids), rid, seqs, state.regs[gslots], state.keys[gslots],
        wire=wf)
    reports = torch.where(mask[..., None], reports, torch.zeros_like(reports))
    FT = state.last_report.shape[0]
    upd = torch.where(mask, gslots, FT).reshape(-1)
    last_report = torch.cat([state.last_report,
                             state.last_report.new_zeros(1)])
    last_report[upd] = U.narrow(U.wide(torch.as_tensor(now, device=dev)))
    seq = U.narrow(U.wide(state.seq) + mask.sum(1))
    return state._replace(last_report=last_report[:FT], seq=seq), reports
