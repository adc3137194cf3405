"""DFA Translator — report routing + RDMA address computation (§III-B/IV-B).

The translator terminates the DTA transport and computes each report's
collector coordinates: the local flow and a per-flow history index from
an 8-bit counter cycling through the ``history`` ring entries. Routing
buckets reports by owning shard for a fixed-capacity exchange; an
out-of-range destination parks in an overflow slot and counts as a
misroute instead of being clipped onto a real shard.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE


class TranslatorState(NamedTuple):
    hist_counter: torch.Tensor   # (F,) u32 — per-flow history counter


def init_state(cfg: DFAConfig, device=None) -> TranslatorState:
    return TranslatorState(torch.zeros(cfg.flows_per_shard,
                                       dtype=torch.int32, device=device))


def compute_addresses(state: TranslatorState, local_flow, mask,
                      cfg: DFAConfig) -> Tuple[TranslatorState, torch.Tensor]:
    """History index per report (int64) + counter update (mod
    ``history``; the counter register wraps at the hist field width).
    Several reports for one flow in a batch take consecutive indices, in
    report order."""
    wrap = WIRE.resolve(cfg).hist_counter_mask
    F = state.hist_counter.shape[0]
    R = local_flow.shape[0]
    dev = local_flow.device
    local_flow = local_flow.to(torch.int64)
    safe = torch.where(mask, local_flow, torch.full_like(local_flow, F))
    order = torch.sort(safe, stable=True).indices
    s = safe[order]
    # s is sorted: a row's run starts at the first row holding its value
    idx_in_run = (torch.arange(R, device=dev)
                  - torch.searchsorted(s, s, side="left"))
    rank = torch.empty_like(idx_in_run)
    rank[order] = idx_in_run
    base = U.wide(state.hist_counter)[torch.clamp(local_flow, 0, F - 1)]
    hist = ((base + rank) & wrap) % cfg.history
    counts = torch.zeros(F + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, safe, mask.to(torch.int64))
    new_counter = ((U.wide(state.hist_counter) + counts[:F]) & wrap) \
        % cfg.history
    return TranslatorState(U.narrow(new_counter)), hist


def translate(state: TranslatorState, reports, mask, shard_flow_base: int,
              cfg: DFAConfig
              ) -> Tuple[TranslatorState, torch.Tensor,
                         Dict[str, torch.Tensor]]:
    """DTA reports (R, 14) -> RoCEv2 payloads (R, 16) + placement coords.
    ``local_flow`` is the flow word as i32 minus the shard's base."""
    wf = WIRE.resolve(cfg)
    rep = PROTO.unpack_dta_report(reports, wire=wf)
    local_flow = (reports[:, wf.report_flow_word].to(torch.int64)
                  - shard_flow_base)
    state, hist = compute_addresses(state, local_flow, mask, cfg)
    payload = PROTO.pack_rocev2_payload(rep, hist, wire=wf)
    payload = torch.where(mask[:, None], payload, torch.zeros_like(payload))
    return state, payload, {"local_flow": local_flow, "hist": hist,
                            "mask": mask}


def route_by_dest(reports, mask, dest, n_buckets: int, capacity_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket reports by destination for a fixed-capacity exchange:
    (R, W) -> ((n_buckets, capacity_out, W), bucket mask, misroutes).
    Masked rows never enter a bucket; overflow drops (counted by the
    caller from the mask sums); a dest outside [0, n_buckets) parks in
    the overflow slot and counts as a misroute. Valid rows form a
    contiguous rank-ordered prefix of each bucket."""
    R, W = reports.shape
    dev = reports.device
    dest = dest.to(torch.int64)
    in_range = (dest >= 0) & (dest < n_buckets)
    misroutes = (mask & ~in_range).sum()
    dest = torch.where(mask & in_range, dest,
                       torch.full_like(dest, n_buckets))
    order = torch.sort(dest, stable=True).indices
    d_sorted = dest[order]
    start = torch.searchsorted(d_sorted,
                               torch.arange(n_buckets, device=dev),
                               side="left")
    rank = torch.arange(R, device=dev) - start[torch.clamp(
        d_sorted, 0, n_buckets - 1)]
    ok = (d_sorted < n_buckets) & (rank < capacity_out)
    slot = torch.where(ok, d_sorted * capacity_out + rank,
                       torch.full_like(rank, n_buckets * capacity_out))
    out = reports.new_zeros(n_buckets * capacity_out + 1, W)
    out[slot] = reports[order]
    out_mask = torch.zeros(n_buckets * capacity_out + 1, dtype=torch.bool,
                           device=dev)
    out_mask[slot] = ok
    return (out[:-1].reshape(n_buckets, capacity_out, W),
            out_mask[:-1].reshape(n_buckets, capacity_out), misroutes)


def route_reports(reports, mask, n_shards: int, flows_per_shard: int,
                  capacity_out: int):
    """Bucket by owning shard: dest = (flow word as i32) // flows_per_shard
    (floor division, so a hostile id that wraps negative misroutes)."""
    flow_id = reports[:, 0].to(torch.int64)
    dest = torch.div(flow_id, flows_per_shard, rounding_mode="floor")
    return route_by_dest(reports, mask, dest, n_shards, capacity_out)


def batch_payloads(payloads, mask, batch: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beyond the paper: pack ``batch`` 64 B payloads into one message
    (paper §VII: "batching could double or triple the overall
    throughput"). (R, W) -> (messages (R // batch, batch * W), message
    mask (R // batch,) — a message is valid if any of its rows is); the
    last R % batch rows are left out."""
    R, W = payloads.shape
    n = R // batch
    msgs = payloads[:n * batch].reshape(n, batch * W)
    mmask = mask[:n * batch].reshape(n, batch).any(dim=-1)
    return msgs, mmask
