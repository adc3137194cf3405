"""DFA Collector — device-resident telemetry sink (§III-C/IV-C, Fig 4).

A (flows x history x 16-word) ring in device memory; payloads land
VERBATIM at the translator-computed coordinates. Placement updates the
ring in place (the GPUDirect analogue): a state passed to :func:`ingest`
shares its ``memory`` / ``entry_valid`` tensors with the returned one.

Integrity on ingest: the per-entry checksum (Fig 4) and per-reporter
sequence continuity (§VI-B) — duplicates inside the window and inside
the batch are rejected before placement (first arrival wins), and seq
gaps count as lost reports. Layout facts come from the wire schema.

The unfused comparison path has its own two entry points:
:func:`staged_ingest` (placement through a staging copy) and
:func:`gather_flow_history` (the explicit (R, H, 16) gather that the
fused :func:`enrich_flow_history` avoids).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE


class CollectorState(NamedTuple):
    memory: torch.Tensor        # (F, H, 16) u32 — Fig 4 region
    entry_valid: torch.Tensor   # (F, H) bool — which entries hold data
    last_seq: torch.Tensor      # (wire.n_reporters,) u32 — seq + 1, 0 = never
    bad_checksum: torch.Tensor  # () u32
    seq_anomalies: torch.Tensor  # () u32
    received: torch.Tensor      # () u32 — total accepted payloads
    lost_reports: torch.Tensor  # () u32 — seq gaps: sent, never landed


def init_state(cfg: DFAConfig, device=None) -> CollectorState:
    F, H = cfg.flows_per_shard, cfg.history
    wf = WIRE.resolve(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return CollectorState(
        memory=z(F, H, PROTO.PAYLOAD_WORDS),
        entry_valid=torch.zeros(F, H, dtype=torch.bool, device=device),
        last_seq=z(wf.n_reporters), bad_checksum=z(), seq_anomalies=z(),
        received=z(), lost_reports=z())


def ingest(state: CollectorState, payloads, mask, shard_flow_base: int,
           cfg: DFAConfig, backend=None) -> CollectorState:
    """payloads: (R, 16) RoCEv2 bodies (int32 bit patterns) routed to this
    shard; placement goes through the ring_scatter family."""
    from repro_torch.kernels.ring_scatter.ops import ring_scatter
    wf = WIRE.resolve(cfg)
    dev = payloads.device
    p = PROTO.unpack_payload(payloads, wire=wf)
    ok_csum = PROTO.payload_valid(payloads, wire=wf)
    bad = (mask & ~ok_csum).sum()
    mask = mask & ok_csum
    local = payloads[:, 0].to(torch.int64) - shard_flow_base
    mask = mask & (local >= 0) & (local < cfg.flows_per_shard)
    n_rep = wf.n_reporters
    rep = p["reporter_id"]
    seq = p["seq"]
    last_seq = U.wide(state.last_seq)
    prev = last_seq[torch.clamp(rep, 0, n_rep - 1)]
    prev_seq = (prev - 1) & wf.seq_mask
    dup_window = (mask & (prev > 0) & (seq <= prev_seq)
                  & (prev_seq - seq < wf.seq_dup_window))
    # in-batch duplicates of one (reporter, seq): stable-sort valid rows
    # by identity, every non-first member of an equal run is a duplicate
    ident = rep * (wf.seq_mask + 1) + seq
    o1 = torch.sort(ident, stable=True).indices
    order = o1[torch.sort((~mask)[o1].to(torch.uint8), stable=True).indices]
    sk, sm = ident[order], mask[order]
    run = torch.zeros_like(sm)
    run[1:] = (sk[1:] == sk[:-1]) & sm[1:] & sm[:-1]
    dup_batch = torch.empty_like(run)
    dup_batch[order] = run
    dup = dup_window | dup_batch
    mask_ok = mask & ~dup
    memory, ev = ring_scatter(
        state.memory, state.entry_valid, payloads,
        torch.clamp(local, 0, cfg.flows_per_shard - 1), p["hist_idx"],
        mask_ok, backend=backend)
    sentinel = torch.full_like(rep, n_rep)
    new_seq = torch.cat([last_seq, last_seq.new_zeros(1)])
    new_seq.scatter_reduce_(0, torch.where(mask_ok, rep, sentinel), seq + 1,
                            "amax")
    new_seq = new_seq[:n_rep]
    # seq-gap loss: per reporter the window advanced by (new - old) but
    # only `fresh` of those landed
    fresh = mask_ok & (seq + 1 >= prev)
    cnt = torch.zeros(n_rep + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, torch.where(fresh, rep, sentinel),
                   torch.ones_like(rep))
    gap = (new_seq - last_seq).sum() - cnt[:n_rep].sum()
    return state._replace(
        memory=memory, entry_valid=ev, last_seq=U.narrow(new_seq),
        bad_checksum=U.narrow(U.wide(state.bad_checksum) + bad),
        seq_anomalies=U.narrow(U.wide(state.seq_anomalies) + dup.sum()),
        received=U.narrow(U.wide(state.received) + mask_ok.sum()),
        lost_reports=U.narrow(U.wide(state.lost_reports) + gap))


def staged_ingest(state: CollectorState, payloads, mask, shard_flow_base: int,
                  cfg: DFAConfig, backend=None) -> CollectorState:
    """The DTA-style comparison path (Fig 3 red): payloads first land in
    a separate staging tensor, then :func:`ingest` places them from
    there. The staging copy is a device-to-device ``clone()`` on the
    payloads' own device — the analogue of the reference's extra copy,
    not a PCIe round trip through host memory. Same result as
    :func:`ingest`, one more pass over the payloads."""
    staging = payloads.clone()
    return ingest(state, staging, mask, shard_flow_base, cfg,
                  backend=backend)


def gather_flow_history(state: CollectorState, local_flow):
    """(R,) local flows -> ((R, H, 16) ring entries, (R, H) validity),
    the input of the standalone derived_features stage. Ids are clamped
    to [0, F), as the reference's gather clamps them."""
    lf = torch.clamp(local_flow.to(torch.int64), 0,
                     state.memory.shape[0] - 1)
    return state.memory[lf], state.entry_valid[lf]


def enrich_flow_history(state: CollectorState, local_flow, cfg: DFAConfig,
                        mask=None, backend=None) -> torch.Tensor:
    """(R,) routed local flows -> (R, derived_dim) f32 straight out of the
    ring (fused gather + derivation; masked-out rows are zero)."""
    from repro_torch.core.enrich import enrich_history
    return enrich_history(state.memory, state.entry_valid, local_flow, cfg,
                          mask=mask, backend=backend)
