"""DFA Translator — report routing (§III-B/IV-B); the history addressing
is in :mod:`homes`.

Routing buckets reports by owning shard for a fixed-capacity exchange;
an out-of-range destination parks in an overflow slot and counts as a
misroute instead of being clipped onto a real shard. The 2-D (pod,
shard) mesh adds ``home_flow_ids`` (hash homes in the global keyspace),
``home_coords`` (id -> pod, shard, device) and ``canonical_order`` (the
home translator's arrival order).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import u32 as U
from . import wire as WIRE


class TranslatorState(NamedTuple):
    hist_counter: torch.Tensor   # (F,) u32 — per-flow history counter


def init_state(cfg, device=None) -> TranslatorState:
    return TranslatorState(torch.zeros(cfg.flows_per_shard,
                                       dtype=torch.int32, device=device))


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


def _i32(flow_id) -> torch.Tensor:
    """u32 flow words (int32 bit patterns or widened int64) as their
    signed int32 values, widened to int64 (the reference's
    ``astype(int32)``: ids >= 2^31 go negative)."""
    return U.narrow(flow_id).to(torch.int64)


def home_flow_ids(keys, total_flows: int) -> torch.Tensor:
    """Mesh-shape-independent flow identity: the FNV-1a hash of the stored
    five-tuple into the global ring keyspace [0, total_flows) (int64)."""
    from .reporter import hash_slot
    return hash_slot(keys, total_flows)


def home_coords(flow_id, flows_per_shard: int, shards_per_pod: int,
                n_devices: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global flow id -> (home_pod, home_shard, home_device) under the
    pod-major range sharding of the keyspace (device d = pod *
    shards_per_pod + shard owns [d * fps, (d + 1) * fps)).

    The id is divided as int32, floor toward -inf, as the reference does:
    a hostile id >= 2^31 goes negative, its pod falls outside [0, pods)
    and routing counts it a misroute, while its shard coordinate (floor
    mod) stays in range."""
    dev = torch.div(_i32(flow_id), flows_per_shard, rounding_mode="floor")
    return (torch.div(dev, shards_per_pod, rounding_mode="floor"),
            torch.remainder(dev, shards_per_pod), dev)


def canonical_order(reports, mask, wire: WIRE.WireFormat = WIRE.V1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The home translator's arrival order: the received batch sorted by
    (flow_id, reporter_id, seq), padding rows last.

    The exchange interleaves a flow's reports by mesh shape; history
    indices and placement are order-sensitive, so the home re-sorts on
    what arrived only. The meta word is monotone in (reporter_id, seq)
    in every wire format, so it is the secondary key. Keys are sorted as
    widened u32 values (as int32 patterns the padding key 0xFFFFFFFF
    would sort first), meta first, then flow, both stable."""
    f = torch.where(mask, U.wide(reports[:, wire.report_flow_word]),
                    WIRE.PAD_FLOW_ID)
    meta = torch.where(mask, U.wide(reports[:, wire.report_meta_word]),
                       WIRE.PAD_SORT_KEY)
    o1 = torch.sort(meta, stable=True).indices
    order = o1[torch.sort(f[o1], stable=True).indices]
    return reports[order], mask[order]
