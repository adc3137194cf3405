"""DFA Translator — report routing + RDMA address computation (§III-B/IV-B).

The translator terminates the DTA transport and computes each report's
collector coordinates: the local flow and a per-flow history index from
an 8-bit counter cycling through the ``history`` ring entries. Routing
buckets reports by owning shard for a fixed-capacity exchange; an
out-of-range destination parks in an overflow slot and counts as a
misroute instead of being clipped onto a real shard.

The 2-D (pod, shard) mesh adds the home functions: ``home_flow_ids``
(hash homes in the global keyspace), ``home_coords`` (id -> pod, shard,
device), the rendezvous (HRW) family (``rendezvous_position``,
``rendezvous_flow_ids``, ``node_position``), ``canonical_order`` (the
home translator's arrival order) and ``crosspod_compact`` (the ragged
stage-2 segments).
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


def _i32(flow_id) -> torch.Tensor:
    """u32 flow words (int32 bit patterns or widened int64) as their
    signed int32 values, widened to int64 (the reference's
    ``astype(int32)``: ids >= 2^31 go negative)."""
    return U.narrow(flow_id).to(torch.int64)


def home_flow_ids(keys, total_flows: int) -> torch.Tensor:
    """Mesh-shape-independent flow identity: the FNV-1a hash of the stored
    five-tuple into the global ring keyspace [0, total_flows) (int64)."""
    from repro_torch.core.reporter import hash_slot
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


def _mix32(x) -> torch.Tensor:
    """Finalizer-style u32 bijection (xor-shift-multiply avalanche) on
    widened values; the multiplies go through ``u32.mul``, since the
    constants times a u32 overflow int64."""
    x = U.wide(x)
    x = x ^ (x >> 16)
    x = U.mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = U.mul(x, 0x846CA68B)
    return x ^ (x >> 16)


# decorrelates the ring-slot hash from the per-node rendezvous scores
_HRW_SLOT_SALT = 0x9E3779B9


def rendezvous_position(key_hash, node_ids) -> torch.Tensor:
    """Highest-random-weight winner of each key over ``node_ids``: the
    winner's POSITION in ``node_ids`` (int64). Scores depend only on
    (key hash, node id); ties break toward the lower position (argmax
    takes the first maximum)."""
    salt = _mix32(U.mul(node_ids, 0x9E3779B9) + 1)
    scores = _mix32(U.wide(key_hash)[..., None] ^ salt)
    return torch.argmax(scores, dim=-1)


def rendezvous_flow_ids(keys, node_ids, flows_per_shard: int
                        ) -> torch.Tensor:
    """Elastic flow identity: ``node_id * fps + slot`` (u32, int64), with
    ``node_id`` the key's HRW winner over the logical node roster and
    ``slot`` an independent hash into that node's ring."""
    from repro_torch.core.reporter import hash_u32
    kh = hash_u32(keys)
    pos = rendezvous_position(kh, node_ids)
    slot = _mix32(kh ^ _HRW_SLOT_SALT)
    fps = int(flows_per_shard)
    slot = slot & (fps - 1) if fps & (fps - 1) == 0 else slot % fps
    return (U.mul(U.wide(node_ids)[pos], fps) + slot) & U.MASK


def node_position(node, node_ids) -> torch.Tensor:
    """Stable node id -> its position in the sorted ``node_ids`` roster
    (the device index, pod-major), clipped into the roster (int64)."""
    pos = torch.searchsorted(U.wide(node_ids).contiguous(),
                             U.wide(node).contiguous())
    return torch.clamp(pos, 0, node_ids.shape[0] - 1)


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


def crosspod_compact(reports, mask, own_pod: int, n_pods: int,
                     capacity: int, hpod_fn, wire: WIRE.WireFormat = WIRE.V1):
    """Compact stage-2 segments for the ragged pod exchange: rows homed on
    ``own_pod`` stay local; the rest are canonically ordered (flow-major)
    and packed into per-destination segments of ``capacity`` rows.
    ``hpod_fn`` maps flow words to home-pod indices.

    Returns ``(local_rows, local_mask, buckets, bucket_mask, misroutes,
    n_messages)``: local rows with masked rows zeroed, the (n_pods,
    capacity, W) segments, and the number of (destination, flow) runs —
    the batched messages a wire transport would send."""
    hpod = hpod_fn(reports[:, wire.report_flow_word])
    is_local = mask & (hpod == own_pod)
    remote = mask & (hpod != own_pod)
    local_rows = torch.where(is_local[:, None], reports,
                             torch.zeros_like(reports))
    rr, rm = canonical_order(reports, remote, wire=wire)
    buckets, bmask, misroutes = route_by_dest(
        rr, rm, hpod_fn(rr[:, wire.report_flow_word]), n_pods, capacity)
    # valid rows are a contiguous prefix of each segment: a message starts
    # at a segment's first valid row or where the flow changes
    flows = buckets[:, :, wire.report_flow_word]
    n_messages = (bmask[:, :1].sum()
                  + (bmask[:, 1:] & (flows[:, 1:] != flows[:, :-1])).sum())
    return local_rows, is_local, buckets, bmask, misroutes, n_messages


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
