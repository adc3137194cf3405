"""DFA Collector — device-resident telemetry sink (§III-C/IV-C, Fig 4):
its state and the last-write-wins ring placement. The integrity checks
on ingest are in :mod:`homes`.

A (flows x history x 16-word) ring in device memory; payloads land
VERBATIM at the translator-computed coordinates, in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import protocol as PROTO
from . import wire as WIRE


class CollectorState(NamedTuple):
    memory: torch.Tensor        # (F, H, 16) u32 — Fig 4 region
    entry_valid: torch.Tensor   # (F, H) bool — which entries hold data
    last_seq: torch.Tensor      # (wire.n_reporters,) u32 — seq + 1, 0 = never
    bad_checksum: torch.Tensor  # () u32
    seq_anomalies: torch.Tensor  # () u32
    received: torch.Tensor      # () u32 — total accepted payloads
    lost_reports: torch.Tensor  # () u32 — seq gaps: sent, never landed


def init_state(cfg, device=None) -> CollectorState:
    F, H = cfg.flows_per_shard, cfg.history
    wf = WIRE.resolve(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return CollectorState(
        memory=z(F, H, PROTO.PAYLOAD_WORDS),
        entry_valid=torch.zeros(F, H, dtype=torch.bool, device=device),
        last_seq=z(wf.n_reporters), bad_checksum=z(), seq_anomalies=z(),
        received=z(), lost_reports=z())


def ring_scatter(memory, entry_valid, payloads, flow, hist, mask):
    """Last-write-wins placement: each touched (flow, hist) cell's winner,
    the highest masked row, writes its payload verbatim and marks the
    cell valid, in place on ``memory`` / ``entry_valid``.

    Every row writes: a row in the ring writes its cell's winner payload,
    a row outside it writes the first in-ring row's cell the same way (or,
    where no row is in the ring, cell 0 its own content). Rows that share
    a cell write equal values, so the order of the writes does not matter
    and no row count has to reach the host."""
    F, H, W = memory.shape
    R = flow.shape[0]
    flow = flow.to(torch.int64)
    hist = hist.to(torch.int64)
    ok = mask & (flow >= 0) & (flow < F) & (hist >= 0) & (hist < H)
    cell = torch.where(ok, flow * H + hist, torch.full_like(flow, F * H))
    rows = torch.arange(R, device=flow.device)
    win = torch.full((F * H + 1,), -1, dtype=torch.int64, device=flow.device)
    win.scatter_reduce_(0, torch.where(ok, cell, F * H), torch.where(
        ok, rows, -1), "amax")
    any_ok = ok.any()
    first = cell[torch.argmax(ok.to(torch.int8))]
    fallback = torch.where(any_ok, first, 0)
    tgt = torch.where(ok, cell, fallback)
    src = torch.where(ok, win[cell], torch.where(any_ok, win[fallback], -1))
    mem = memory.view(F * H, W)
    val = mem[tgt]
    val = torch.where((src >= 0)[:, None], payloads[src.clamp(min=0)], val)
    valid = entry_valid.view(F * H)
    flag = torch.where(src >= 0, True, valid[tgt])
    mem[tgt] = val
    valid[tgt] = flag
    return memory, entry_valid
