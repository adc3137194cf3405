"""Every home shard's translator and collector at once: the n shards'
tables as one (flow f of shard d at d * F + f; reporter r of shard d at
d * n_reporters + r), the reports each shard received as (n, R, ...),
the counters per shard.

The same operations as :mod:`translator` (history addressing, payload
packing) and :mod:`collector` (checksum and range checks, duplicate
rejection in the window and in the batch, last-write-wins placement,
seq-gap loss), done once for all shards. Rows of different shards never
share a flow or a reporter index, so each shard's result is the one its
own tables would give.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import collector as COLL
from . import protocol as PROTO
from . import u32 as U
from . import wire as WIRE


def _per_shard(values, shard, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int64, device=shard.device)
    return out.index_add_(0, shard, values.to(torch.int64))


def translate(hist_counter, reports, mask, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, R, report_words) reports and (n, R) masks -> (the history
    counters, (n * R, 16) payloads, (n * R,) local flows)."""
    n, R, _ = reports.shape
    F = cfg.flows_per_shard
    wf = WIRE.resolve(cfg)
    wrap = wf.hist_counter_mask
    dev = reports.device
    rows = reports.reshape(n * R, -1)
    m = mask.reshape(-1)
    shard = torch.arange(n * R, device=dev) // R
    base = shard * F                      # shard d's flows start at d * F
    flow = rows[:, wf.report_flow_word].to(torch.int64)
    local = flow - base
    safe = torch.where(m, flow, n * F)
    order = torch.sort(safe, stable=True).indices
    s = safe[order]
    rank = torch.empty_like(s)
    rank[order] = (torch.arange(n * R, device=dev)
                   - torch.searchsorted(s, s, side="left"))
    counter = U.wide(hist_counter)
    start = counter[torch.clamp(shard * F + torch.clamp(local, 0, F - 1),
                                0, n * F - 1)]
    hist = ((start + rank) & wrap) % cfg.history
    counts = torch.zeros(n * F + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, safe, m.to(torch.int64))
    new_counter = ((counter + counts[:n * F]) & wrap) % cfg.history
    payload = PROTO.pack_rocev2_payload(
        PROTO.unpack_dta_report(rows, wire=wf), hist, wire=wf)
    payload = torch.where(m[:, None], payload, torch.zeros_like(payload))
    return U.narrow(new_counter), payload, local


def ingest(state: COLL.CollectorState, payloads, mask, cfg
           ) -> COLL.CollectorState:
    """(n * R, 16) payloads, (n, R) masks -> the collector tables."""
    n, R = mask.shape
    F = cfg.flows_per_shard
    wf = WIRE.resolve(cfg)
    n_rep = wf.n_reporters
    dev = payloads.device
    m = mask.reshape(-1)
    shard = torch.arange(n * R, device=dev) // R
    p = PROTO.unpack_payload(payloads, wire=wf)
    ok_csum = PROTO.payload_valid(payloads, wire=wf)
    bad = _per_shard(m & ~ok_csum, shard, n)
    m = m & ok_csum
    base = shard * F                      # shard d's flows start at d * F
    local = payloads[:, 0].to(torch.int64) - base
    m = m & (local >= 0) & (local < F)
    rep, seq = p["reporter_id"], p["seq"]
    grep = shard * n_rep + rep
    last_seq = U.wide(state.last_seq)
    prev = last_seq[shard * n_rep + torch.clamp(rep, 0, n_rep - 1)]
    prev_seq = (prev - 1) & wf.seq_mask
    dup_window = (m & (prev > 0) & (seq <= prev_seq)
                  & (prev_seq - seq < wf.seq_dup_window))
    ident = grep * (wf.seq_mask + 1) + seq
    o1 = torch.sort(ident, stable=True).indices
    order = o1[torch.sort((~m)[o1].to(torch.uint8), stable=True).indices]
    sk, sm = ident[order], m[order]
    run = torch.zeros_like(sm)
    run[1:] = (sk[1:] == sk[:-1]) & sm[1:] & sm[:-1]
    dup_batch = torch.empty_like(run)
    dup_batch[order] = run
    dup = dup_window | dup_batch
    ok = m & ~dup
    memory, ev = COLL.ring_scatter(
        state.memory, state.entry_valid, payloads,
        shard * F + torch.clamp(local, 0, F - 1), p["hist_idx"], ok)
    sentinel = torch.full_like(grep, n * n_rep)
    new_seq = torch.cat([last_seq, last_seq.new_zeros(1)])
    new_seq.scatter_reduce_(0, torch.where(ok, grep, sentinel), seq + 1,
                            "amax")
    new_seq = new_seq[:n * n_rep]
    fresh = ok & (seq + 1 >= prev)
    cnt = torch.zeros(n * n_rep + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, torch.where(fresh, grep, sentinel),
                   torch.ones_like(grep))
    gap = ((new_seq - last_seq).view(n, n_rep).sum(1)
           - cnt[:n * n_rep].view(n, n_rep).sum(1))
    return state._replace(
        memory=memory, entry_valid=ev, last_seq=U.narrow(new_seq),
        bad_checksum=U.narrow(U.wide(state.bad_checksum) + bad),
        seq_anomalies=U.narrow(U.wide(state.seq_anomalies)
                               + _per_shard(dup, shard, n)),
        received=U.narrow(U.wide(state.received)
                          + _per_shard(ok, shard, n)),
        lost_reports=U.narrow(U.wide(state.lost_reports) + gap))
