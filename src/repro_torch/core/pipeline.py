"""The DFA monitoring period, end to end (Fig 1), on one shard or on an
emulated mesh of shards.

One period is two half-steps:

  ``ingest_half``  reporter ingest of the packet events into the Table-I
                   registers -> due flows -> DTA reports -> routing to the
                   home shards -> translator history addressing ->
                   (optional transport fault injection, ``data.faults``)
                   -> checksum- and seq-checked placement into the
                   collector ring;
  ``enrich_half``  fused history gather + feature derivation of the
                   routed flows into (R, derived_dim) f32 features, plus
                   the optional immediate-inference head.

Drivers: ``dfa_step`` (one period), ``run_periods`` (T periods, each
ingest then enrich), ``run_periods_overlapped`` (the reference's
software-pipelined order: one warm-up ingest, then per period the enrich
of the carried batch followed by the ingest of the next, then one drain
enrich) and ``stream`` (either driver, optionally chunked at snapshot
boundaries with an asynchronous checkpoint after each chunk).
The two drivers are bit-identical by construction: the deferred enrich
of period t still reads the ring after period t's placement and before
period t+1's, and both halves run in order on the current CUDA stream.

The three hot stages are the CUDA kernels ``ingest_segment_sums``,
``ring_scatter`` and ``gather_enrich`` on the card and their plain
PyTorch versions on the CPU (``repro_torch.kernels.dispatch``);
everything around them is torch ops.

**The mesh.** ``DFASystem(cfg, n_shards=n)`` runs n shards (devices of
the reference's mesh) in one process on one device, pod-major as a
(``cfg.pods``, n // pods) mesh. The state has the reference's global
layout: translator and collector tables stacked shard by shard along the
leading dim, one reporter table per port, per-shard (per-port) scalar
counters as (n,) ((total_ports,)) vectors. Each shard's body runs on
leading-dim views of those tensors, so ring placement still writes the
ring in place. The reference's collectives become tensor ops: its
``all_to_all`` is a transpose of the stacked (source, destination)
buckets, ``psum`` a sum over shards and ``pmax`` a max over the shard
dim. ``flow_home="ingest"`` is the 1-D mesh (flows homed on their ingest
shard); ``"hash"`` and ``"rendezvous"`` are the 2-D (pod, shard) mesh:
per-port reporter tables, hash-home or HRW flow ids, a two-stage
exchange (within the pod by home shard, then across pods, padded or
ragged), and the home translator's canonical order, which makes the
merged state independent of how the devices factor into pods.

State tensors are updated in place where that saves memory: the
collector ring (84 MB per shard at PAPER scale) is written by ring
placement directly, so a state passed into a step shares its ring with
the state that comes out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import collector as COLL
from repro_torch.core import reporter as REP
from repro_torch.core import translator as TRANS
from repro_torch.core import wire as WIRE
from repro_torch.data import faults as FAULTS
from repro_torch.device import on_card_or_cpu
from repro_torch.kernels import dispatch

METRIC_KEYS = ("reports_sent", "reports_recv", "bucket_drops", "misroutes",
               "collisions", "bad_checksum", "seq_anomalies", "lost_reports")


class DFAState(NamedTuple):
    reporter: REP.ReporterState
    translator: TRANS.TranslatorState
    collector: COLL.CollectorState


class RoutedBatch(NamedTuple):
    """One period's routing products, carried into the enrich half."""
    local_flow: torch.Tensor   # (R,) int64 — owner-shard-local flow coords
    flow_id: torch.Tensor      # (R,) int64 — global flow ids (u32 values)
    mask: torch.Tensor         # (R,) bool — routed-report validity


class StepOutputs(NamedTuple):
    """Return of every driver; streaming drivers stack the per-period
    fields under a leading (T,) dim. ``preds`` is None unless a head is
    armed."""
    state: DFAState
    enriched: torch.Tensor            # ([T,] R, derived_dim) f32
    flow_ids: torch.Tensor            # ([T,] R) int64 (0xFFFFFFFF = pad)
    mask: torch.Tensor                # ([T,] R) bool
    metrics: Dict[str, torch.Tensor]  # per-period deltas, int64
    preds: Optional[torch.Tensor] = None


# per-unit scalar counters: (units,) vectors in the global state, 0-d in
# one unit's view
_SCALARS = frozenset(("seq", "collisions", "bad_checksum", "seq_anomalies",
                      "received", "lost_reports"))


def _part(st, k: int, count: int):
    """Unit ``k``'s view of a state tiled over ``count`` units (shards, or
    ports for the reporter): leading-dim slices of the tables, 0-d views
    of the scalar counters. Every view shares storage with ``st``."""
    def view(f, t):
        if f in _SCALARS:
            return t[k]
        u = t.shape[0] // count
        return t[k * u:(k + 1) * u]
    return type(st)(*(view(f, t) for f, t in zip(st._fields, st)))


def _join(parts, whole):
    """Per-unit states back into one tiled state shaped like ``whole``. A
    table every unit still holds as its view of ``whole`` (the ring,
    written in place) is ``whole``'s own tensor; the others are
    concatenated (one unit: taken as they are)."""
    n = len(parts)
    out = []
    for i, f in enumerate(whole._fields):
        w, ps = whole[i], [p[i] for p in parts]
        if f in _SCALARS:
            out.append(ps[0].reshape(1) if n == 1 else torch.stack(ps))
            continue
        u = w.shape[0] // n
        if all(p.data_ptr() == w[k * u:(k + 1) * u].data_ptr()
               and p.shape == w[k * u:(k + 1) * u].shape
               for k, p in enumerate(ps)):
            out.append(w)
        else:
            out.append(ps[0] if n == 1 else torch.cat(ps))
    return type(whole)(*out)


def _stack(xs: List[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` that makes no copy of a single tensor."""
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


def _cat(xs: List[torch.Tensor]) -> torch.Tensor:
    """``torch.cat`` that makes no copy of a single tensor."""
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def _global_seq_gap(coll: COLL.CollectorState, pre: COLL.CollectorState):
    """Replace the collectors' shard-local seq-gap counts with the global
    one. A reporter's seqs fan out over the home shards, so per reporter
    the window advance is the max over shards (the reference's ``pmax``)
    and the accepted arrivals the sum over shards (``psum``); their
    difference is the number of reports that landed nowhere. It lands on
    shard 0 only, added to the pre-period counters (the local deltas are
    discarded), so sums over shards stay exact. ``coll`` is the joined
    post-ingest state, ``pre`` the pre-period one. Returns (coll',
    lost_delta)."""
    n = pre.received.shape[0]
    advanced = (U.wide(coll.last_seq).reshape(n, -1).amax(0).sum()
                - U.wide(pre.last_seq).reshape(n, -1).amax(0).sum())
    arrivals = (U.wide(coll.received) - U.wide(pre.received)).sum()
    lost_delta = (advanced - arrivals) & U.MASK
    lead = torch.arange(n, device=lost_delta.device) == 0
    lost = U.wide(pre.lost_reports) + torch.where(lead, lost_delta, 0)
    return coll._replace(lost_reports=U.narrow(lost)), lost_delta


def _delta(new, old) -> torch.Tensor:
    """Period delta of u32 counters summed over all units (wrap-safe)."""
    return (U.wide(new).sum() - U.wide(old).sum()) & U.MASK


def _events(events: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in events.items()}


def _events_per(events: Dict[str, torch.Tensor], units: int, what: str
                ) -> int:
    """Events per shard (or device): the batch must split evenly."""
    N = events["ts"].shape[0]
    if N % units:
        raise ValueError(
            f"event count {N} must divide across {units} {what}s — a "
            "truncated split would silently drop trailing events")
    return N // units


def _i32(x: int) -> int:
    """A u32 value as the int32 it reads as."""
    return ((x & U.MASK) ^ 0x80000000) - 0x80000000


class DFASystem:
    """The DFA system on ``device`` (the CUDA card unless the caller asks
    for ``"cpu"``), over ``n_shards`` emulated shards.

    ``infer_params``: numpy parameters of the reference's inference head
    (``{"w", "b"}`` or ``{"w1", "b1", "w2", "b2"}``); without them an
    armed head (``cfg.inference_head``) draws its weights from a seeded
    ``torch.Generator``."""

    def __init__(self, cfg: DFAConfig, device="cuda", infer_params=None,
                 n_shards: int = 1):
        device = on_card_or_cpu(device, "DFASystem")
        backend = dispatch.check_backend(cfg.kernel_backend)
        if backend == "cuda" and device.type != "cuda":
            raise RuntimeError("kernel_backend='cuda' needs device='cuda'")
        self.wire = WIRE.resolve(cfg)
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self.n_shards = int(n_shards)
        self._derive_topology()
        self._nodes = torch.tensor(self.home_nodes, dtype=torch.int64,
                                   device=device)
        self.head = None
        if cfg.inference_head != "none":
            from repro_torch.models.flow_head import FlowHead
            self.head = FlowHead(cfg, device=device)
            if infer_params is not None:
                from repro_torch.convert import head_params_from_numpy
                head_params_from_numpy(self.head, infer_params)

    def _derive_topology(self) -> None:
        """(pod, shard) factorization and port placement, with the
        reference's checks and messages (``_derive_topology``). The pod
        axis is ``cfg.pods``: the n devices form a (pods, n // pods) mesh,
        pod-major. Under ``"hash"`` / ``"rendezvous"`` each device hosts
        ``total_ports / n`` per-port reporter tables, in pod-major port
        order."""
        cfg = self.cfg
        n = self.n_shards
        if n < 1:
            raise ValueError(f"n_shards must be >= 1, got {n}")
        if cfg.flow_home not in ("ingest", "hash", "rendezvous"):
            raise ValueError(
                f"flow_home must be 'ingest', 'hash' or 'rendezvous', got "
                f"{cfg.flow_home!r}")
        if cfg.pods < 1 or n % cfg.pods:
            raise ValueError(
                f"cfg.pods={cfg.pods} does not divide the {n}-device mesh: "
                "the pod axis must split the devices into equal pods")
        self.mesh_pods = int(cfg.pods)
        self.shards_per_pod = n // self.mesh_pods
        self.total_flows = n * cfg.flows_per_shard
        self.multipod = cfg.flow_home in ("hash", "rendezvous")
        if cfg.crosspod_exchange not in ("padded", "ragged"):
            raise ValueError(
                f"crosspod_exchange must be 'padded' or 'ragged', got "
                f"{cfg.crosspod_exchange!r}")
        self.crosspod_exchange = cfg.crosspod_exchange
        if cfg.crosspod_capacity < 0:
            raise ValueError(
                f"crosspod_capacity must be >= 0 (0 = worst-case "
                f"auto-size), got {cfg.crosspod_capacity}")
        if not self.multipod:
            if cfg.crosspod_exchange != "padded":
                raise ValueError(
                    "crosspod_exchange='ragged' compresses the stage-2 "
                    "pod exchange, which only exists under "
                    "flow_home='hash'/'rendezvous'; the legacy 'ingest' "
                    "scheme has no pod stage to compress")
            if cfg.crosspod_capacity:
                raise ValueError(
                    "crosspod_capacity sizes the ragged stage-2 segments "
                    "and is meaningless under flow_home='ingest'")
        if cfg.flow_home == "rendezvous":
            nodes = tuple(cfg.home_nodes) or tuple(range(n))
            if len(nodes) != n:
                raise ValueError(
                    f"home_nodes has {len(nodes)} entries for a "
                    f"{n}-device mesh: one logical node id "
                    "per device (pod-major), so the rendezvous winner "
                    "set and the mesh agree on who owns what")
            if any(b <= a for a, b in zip(nodes, nodes[1:])) or nodes[0] < 0:
                raise ValueError(
                    f"home_nodes must be strictly increasing non-negative "
                    f"ids, got {nodes}: sorted order is what keeps HRW "
                    "tie-breaking and node_position lookups mesh-invariant")
            self.home_nodes: Tuple[int, ...] = nodes
        else:
            self.home_nodes = tuple(range(n))
        if not self.multipod:
            if self.mesh_pods > 1:
                raise ValueError(
                    "a multi-pod mesh needs flow_home='hash': the legacy "
                    "'ingest' scheme homes every flow on its ingest shard "
                    "and would never exercise the cross-pod exchange")
            if cfg.ports_per_pod and cfg.ports_per_pod != n:
                raise ValueError(
                    "flow_home='ingest' supports exactly one port per "
                    f"shard ({n}), got ports_per_pod={cfg.ports_per_pod}")
            if cfg.reporter_slots and (cfg.reporter_slots
                                       != cfg.flows_per_shard):
                raise ValueError(
                    "flow_home='ingest' mints flow ids from the shard "
                    "range, so reporter_slots must equal flows_per_shard")
            self.total_ports = n
            self.ports_per_device = 1
            self.rep_cfg = cfg
            self.port_capacity = 0
            self.stage1_capacity = 0
            self.stage2_capacity = 0
            self.crosspod_capacity = 0
            return
        total_ports = (self.mesh_pods * cfg.ports_per_pod
                       if cfg.ports_per_pod else n)
        if total_ports % n:
            raise ValueError(
                f"total ports ({self.mesh_pods} pods x "
                f"{cfg.ports_per_pod}/pod = {total_ports}) must be a "
                f"multiple of the device count {n}")
        if total_ports > self.wire.n_reporters:
            # two ports would alias one reporter id, and the home's
            # canonical (flow, reporter, seq) order would stop being
            # deterministic
            raise ValueError(
                f"total ports {total_ports} exceeds the "
                f"{self.wire.reporter_width}-bit reporter id space of "
                f"wire format {self.wire.name!r} "
                f"({self.wire.n_reporters}); canonical report ordering "
                "requires a unique (flow, reporter) pair per period — "
                "set wire_format='v2' (or REPRO_WIRE_FORMAT=v2) for "
                "u16 reporter ids")
        self.total_ports = total_ports
        self.ports_per_device = total_ports // n
        self.rep_cfg = (dataclasses.replace(
            cfg, flows_per_shard=cfg.reporter_table_slots())
            if cfg.reporter_slots else cfg)
        self.port_capacity = cfg.port_report_capacity or max(
            1, cfg.report_capacity // total_ports)
        # worst-case stage capacities (every report to one bucket); the
        # ragged exchange's 0 = auto keeps the worst case, drop-free
        self.stage1_capacity = max(
            1, self.ports_per_device * self.port_capacity)
        self.stage2_capacity = self.shards_per_pod * self.stage1_capacity
        if cfg.crosspod_capacity > self.stage2_capacity:
            raise ValueError(
                f"crosspod_capacity={cfg.crosspod_capacity} exceeds the "
                f"worst-case stage-2 capacity {self.stage2_capacity} "
                "(shards_per_pod x stage-1 bucket) — a larger segment "
                "can never fill; this is a misconfiguration")
        if cfg.crosspod_capacity and self.crosspod_exchange != "ragged":
            raise ValueError(
                "crosspod_capacity only applies to "
                "crosspod_exchange='ragged' (the padded exchange always "
                "ships the worst-case buckets)")
        self.crosspod_capacity = (
            (cfg.crosspod_capacity or self.stage2_capacity)
            if self.crosspod_exchange == "ragged" else 0)

    @property
    def fault_spec(self) -> Optional[FAULTS.FaultSpec]:
        """The armed transport-fault schedule, or None (no injection)."""
        fs = self.cfg.fault_spec
        return fs if fs is not None and fs.armed else None

    # -- state ------------------------------------------------------------
    def init_state(self) -> DFAState:
        """The global state: one reporter table per port, translator and
        collector tables stacked per shard, scalar counters as
        per-port / per-shard vectors (the reference's ``init_state``)."""
        def tile(st, count):
            return type(st)(*(t.reshape(1).repeat(count) if t.dim() == 0
                              else t.repeat((count,) + (1,) * (t.dim() - 1))
                              for t in st))

        n = self.n_shards
        return DFAState(
            tile(REP.init_state(self.rep_cfg, self.device), self.total_ports),
            tile(TRANS.init_state(self.cfg, self.device), n),
            tile(COLL.init_state(self.cfg, self.device), n))

    # -- the two half-steps -----------------------------------------------
    def ingest_half(self, state: DFAState, events: Dict[str, torch.Tensor],
                    now, backend=None
                    ) -> Tuple[DFAState, RoutedBatch,
                               Dict[str, torch.Tensor]]:
        """Reporter ingest, due-flow reports, routing to the home shards,
        translator addressing, the optional fault injector and ring
        placement, for every shard. events: ts/size (n_shards * E,),
        five_tuple (n_shards * E, 5) (int32 bit patterns), valid bool,
        shard-major (port-major on the 2-D mesh); ``now`` a u32 value
        (int or 0-d tensor). Metrics are per-period deltas summed over the
        shards (int64 scalars); with faults armed they also hold the
        ``injected_*`` counts and the per-row fault ledger, shard by shard
        (``data.faults``). Drawing the fault schedule reads ``now`` on the
        host, which waits for the card when ``now`` lives there."""
        b = backend or self.backend
        if self.multipod:
            return self._ingest_half_mesh2d(state, events, now, b)
        cfg, wf = self.cfg, self.wire
        n, F = self.n_shards, cfg.flows_per_shard
        cap_out = max(1, cfg.report_capacity // n)
        E = _events_per(events, n, "shard")
        reps, buckets, bmasks = [], [], []
        sent = drops = mis = 0
        for s in range(n):
            rep_s = REP.ingest(_part(state.reporter, s, n),
                               _events(events, s * E, (s + 1) * E), cfg,
                               backend=b)
            slots, mask = REP.due_flows(rep_s, now, cfg, cfg.report_capacity)
            rep_s, reports = REP.make_reports(rep_s, slots, mask, now, 0,
                                              s * F, cfg)
            # reporter id = shard (mod the schema's reporter id space)
            mw = wf.report_meta_word
            meta = wf.set_report_reporter(reports[:, mw], torch.full_like(
                reports[:, mw], s % wf.n_reporters))
            reports[:, mw] = U.narrow(torch.where(mask, meta, 0))
            bk, bm, mi = TRANS.route_reports(reports, mask, n, F, cap_out)
            reps.append(rep_s)
            buckets.append(bk)
            bmasks.append(bm)
            sent = sent + mask.sum()
            drops = drops + mask.sum() - bm.sum() - mi
            mis = mis + mi
        # all_to_all: source s's bucket d lands on shard d, sources in order
        routed = _stack(buckets).transpose(0, 1).reshape(
            n, n * cap_out, wf.report_words)
        rmask = _stack(bmasks).transpose(0, 1).reshape(n, n * cap_out)
        counts = {"reports_sent": sent, "reports_recv": rmask.sum(),
                  "bucket_drops": drops, "misroutes": mis}
        return self._home_half(state, reps, routed, rmask,
                               [s * F for s in range(n)], now, b, counts)

    def _ingest_half_mesh2d(self, state: DFAState, events, now, b):
        """The 2-D (pod, shard) mesh's ingest half (``flow_home`` "hash"
        or "rendezvous"), the reference's ``_ingest_half_mesh2d``:

          1. every port ingests its own event slice into its own reporter
             table (``ports_per_device`` per device, pod-major);
          2. its due reports carry the hash-home (or HRW) global flow id
             and reporter id = global port index;
          3. stage 1: buckets by home shard, exchanged within the pod;
          4. stage 2: buckets by home pod, exchanged across pods — padded,
             or ragged (pod-local rows stay, remote rows pre-merged and
             packed into ``crosspod_capacity``-row segments);
          5. the home translator orders what arrived canonically by
             (flow, reporter, seq), then addresses and places as the 1-D
             path does.
        """
        cfg, wf = self.cfg, self.wire
        n, S, pods = self.n_shards, self.shards_per_pod, self.mesh_pods
        TP, P_l, R_p = self.total_ports, self.ports_per_device, \
            self.port_capacity
        cap1, cap2 = self.stage1_capacity, self.stage2_capacity
        ragged = self.crosspod_exchange == "ragged"
        cap2c = self.crosspod_capacity
        fps, G = cfg.flows_per_shard, self.total_flows
        hrw = cfg.flow_home == "rendezvous"
        nodes = self._nodes
        W = wf.report_words
        E_dev = _events_per(events, n, "device")
        if E_dev % P_l:
            raise ValueError(
                f"per-device event count {E_dev} must divide across {P_l} "
                "hosted ports — a truncated split would silently drop "
                "trailing events and shift every port's slice off the "
                "port-major trace layout")
        E_p = E_dev // P_l
        reps, reports, masks = [], [], []
        for g in range(TP):
            pst = REP.ingest(_part(state.reporter, g, TP),
                             _events(events, g * E_p, (g + 1) * E_p),
                             self.rep_cfg, backend=b)
            slots, mask = REP.due_flows(pst, now, self.rep_cfg, R_p)
            keys = pst.keys[slots]
            fids = (TRANS.rendezvous_flow_ids(keys, nodes, fps) if hrw
                    else TRANS.home_flow_ids(keys, G))
            pst, rep = REP.make_reports(pst, slots, mask, now,
                                        g % wf.n_reporters, 0, self.rep_cfg,
                                        flow_ids=fids)
            reps.append(pst)
            reports.append(rep)
            masks.append(mask)
        reports = _stack(reports).view(n, P_l * R_p, W)
        masks = _stack(masks).view(n, P_l * R_p)

        if hrw:
            def node_pos(fid):
                return TRANS.node_position(
                    torch.div(U.wide(fid), fps, rounding_mode="floor"),
                    nodes)

            def hshard_of(fid):
                return torch.remainder(node_pos(fid), S)

            def hpod_of(fid):
                return torch.div(node_pos(fid), S, rounding_mode="floor")
        else:
            def hshard_of(fid):
                return TRANS.home_coords(fid, fps, S, n)[1]

            def hpod_of(fid):
                return TRANS.home_coords(fid, fps, S, n)[0]
        # stage 1: by home shard (in range even for a corrupt id, so its
        # misroutes are 0 and the pod coordinate carries the signal)
        b1, m1 = [], []
        drops = mis = 0
        for d in range(n):
            bk, bm, mi = TRANS.route_by_dest(
                reports[d], masks[d], hshard_of(reports[d][:, 0]), S, cap1)
            b1.append(bk)
            m1.append(bm)
            drops = drops + masks[d].sum() - bm.sum() - mi
            mis = mis + mi
        # all_to_all over the shards of each pod: (pod, source, dest) ->
        # (pod, dest, source)
        r1 = _stack(b1).view(pods, S, S, cap1, W).transpose(1, 2).reshape(
            n, S * cap1, W)
        m1 = _stack(m1).view(pods, S, S, cap1).transpose(1, 2).reshape(
            n, S * cap1)
        # stage 2: by home pod
        b2, m2, local, lmask = [], [], [], []
        xsent = xmsg = 0
        for d in range(n):
            if ragged:
                lr, lm, bk, bm, mi, nmsg = TRANS.crosspod_compact(
                    r1[d], m1[d], d // S, pods, cap2c, hpod_of, wire=wf)
                local.append(lr)
                lmask.append(lm)
                drops = drops + m1[d].sum() - lm.sum() - bm.sum() - mi
                xsent = xsent + bm.sum()
                xmsg = xmsg + nmsg
            else:
                bk, bm, mi = TRANS.route_by_dest(
                    r1[d], m1[d], hpod_of(r1[d][:, 0]), pods, cap2)
                drops = drops + m1[d].sum() - bm.sum() - mi
            b2.append(bk)
            m2.append(bm)
            mis = mis + mi
        cap = cap2c if ragged else cap2
        # all_to_all over the pods of each shard column: (source pod,
        # shard, dest pod) -> (dest pod, shard, source pod)
        routed = _stack(b2).view(pods, S, pods, cap, W).permute(
            2, 1, 0, 3, 4).reshape(n, pods * cap, W)
        rmask = _stack(m2).view(pods, S, pods, cap).permute(
            2, 1, 0, 3).reshape(n, pods * cap)
        if ragged:
            routed = torch.cat([_stack(local), routed], dim=1)
            rmask = torch.cat([_stack(lmask), rmask], dim=1)
        # the home's canonical arrival order
        ordered = [TRANS.canonical_order(routed[d], rmask[d], wire=wf)
                   for d in range(n)]
        routed = _stack([o[0] for o in ordered])
        rmask = _stack([o[1] for o in ordered])
        counts = {"reports_sent": masks.sum(), "reports_recv": rmask.sum(),
                  "bucket_drops": drops, "misroutes": mis}
        if ragged:
            counts.update({"crosspod_sent": xsent,
                           "crosspod_messages": xmsg})
        bases = [_i32(self.home_nodes[d] * fps) if hrw else d * fps
                 for d in range(n)]
        return self._home_half(state, reps, routed, rmask, bases, now, b,
                               counts)

    def _home_half(self, state: DFAState, reps, routed, rmask, bases, now, b,
                   counts):
        """Each shard's home side: translator addressing, the optional
        fault injector, ring placement; then the joined state, the global
        seq gap and the metrics summed over shards. ``routed`` (n, R, W)
        and ``rmask`` (n, R) are what landed on each shard; ``bases`` the
        shards' flow bases."""
        cfg, wf, n = self.cfg, self.wire, self.n_shards
        trs, colls, lflows = [], [], []
        fcounts, fledger = {}, {}
        for d in range(n):
            tr_d, payloads, coords = TRANS.translate(
                _part(state.translator, d, n), routed[d], rmask[d],
                bases[d], cfg)
            # faults hit only what the collector sees; the routed
            # coordinates stay what the switch emitted
            ing_pay, ing_mask = payloads, rmask[d]
            if self.fault_spec is not None:
                ing_pay, ing_mask, fc, fl = FAULTS.inject(
                    payloads, rmask[d], self.fault_spec, wf, now, d)
                for k, v in fc.items():
                    fcounts[k] = fcounts.get(k, 0) + v
                for k, v in fl.items():
                    fledger.setdefault(k, []).append(v)
            colls.append(COLL.ingest(_part(state.collector, d, n), ing_pay,
                                     ing_mask, bases[d], cfg, backend=b))
            trs.append(tr_d)
            lflows.append(coords["local_flow"])
        rep_st = _join(reps, state.reporter)
        coll_st, lost_delta = _global_seq_gap(
            _join(colls, state.collector), state.collector)
        new = DFAState(rep_st, _join(trs, state.translator), coll_st)
        metrics = {
            **counts,
            "collisions": _delta(rep_st.collisions, state.reporter.collisions),
            "bad_checksum": _delta(coll_st.bad_checksum,
                                   state.collector.bad_checksum),
            "seq_anomalies": _delta(coll_st.seq_anomalies,
                                    state.collector.seq_anomalies),
            "lost_reports": lost_delta,
            **fcounts,
            **{k: _cat(v) for k, v in fledger.items()},
        }
        return new, RoutedBatch(_cat(lflows), U.wide(routed[:, :, 0]).reshape(
            -1), rmask.reshape(-1)), metrics

    def enrich_half(self, state: DFAState, routed: RoutedBatch,
                    backend=None):
        """Fused gather + enrichment of the routed flows, each shard on
        its own ring (reads the rings, never writes them), plus the
        optional head. Returns (enriched (n * R, D), flow_ids, mask, preds
        or None)."""
        b = backend or self.backend
        n = self.n_shards
        R = routed.mask.shape[0] // n
        enriched = _cat([COLL.enrich_flow_history(
            _part(state.collector, d, n), routed.local_flow[d * R:(d + 1) * R],
            self.cfg, mask=routed.mask[d * R:(d + 1) * R], backend=b)
            for d in range(n)])
        flow_ids = torch.where(routed.mask, routed.flow_id,
                               WIRE.PAD_FLOW_ID)
        preds = None
        if self.head is not None:
            preds = self.head(enriched)
            preds = torch.where(routed.mask[:, None], preds,
                                torch.zeros_like(preds))
        return enriched, flow_ids, routed.mask, preds

    def dfa_step(self, state: DFAState, events: Dict[str, torch.Tensor],
                 now, backend=None) -> StepOutputs:
        """One full monitoring period = ingest_half then enrich_half."""
        state, routed, metrics = self.ingest_half(state, events, now,
                                                  backend)
        enriched, flow_ids, emask, preds = self.enrich_half(state, routed,
                                                            backend)
        return StepOutputs(state, enriched, flow_ids, emask, metrics, preds)

    # -- multi-period streaming -------------------------------------------
    @staticmethod
    def _stacked(state: DFAState, halves: List[Tuple], metrics: List[Dict]
                 ) -> StepOutputs:
        """Stack per-period enrich results and every metric key under a
        leading (T,) dim."""
        enriched, flow_ids, mask, preds = zip(*halves)
        return StepOutputs(
            state, torch.stack(enriched), torch.stack(flow_ids),
            torch.stack(mask),
            {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]},
            None if preds[0] is None else torch.stack(preds))

    def run_periods(self, state: DFAState, events: Dict[str, torch.Tensor],
                    nows, backend=None) -> StepOutputs:
        """Stream T periods, each a full ingest + enrich chain. events:
        dict of (T, E, ...) tensors; nows: (T,) u32 values. Per-period
        fields come back stacked under (T,)."""
        halves, metrics = [], []
        for t in range(len(nows)):
            state, routed, m = self.ingest_half(
                state, {k: v[t] for k, v in events.items()}, nows[t],
                backend)
            halves.append(self.enrich_half(state, routed, backend))
            metrics.append(m)
        return self._stacked(state, halves, metrics)

    def run_periods_overlapped(self, state: DFAState,
                               events: Dict[str, torch.Tensor], nows,
                               backend=None) -> StepOutputs:
        """Software-pipelined stream, in the reference's order: one
        warm-up ingest; then per period the enrich half of the carried
        batch (reading the ring before this period's placement) and the
        ingest half of the next; one drain enrich. Same signature and
        returns as :meth:`run_periods`, and bit-identical to it."""
        state, prev, m0 = self.ingest_half(
            state, {k: v[0] for k, v in events.items()}, nows[0], backend)
        halves, metrics = [], [m0]
        for t in range(1, len(nows)):
            halves.append(self.enrich_half(state, prev, backend))
            state, prev, m = self.ingest_half(
                state, {k: v[t] for k, v in events.items()}, nows[t],
                backend)
            metrics.append(m)
        halves.append(self.enrich_half(state, prev, backend))
        return self._stacked(state, halves, metrics)

    def stream(self, state: DFAState, events: Dict[str, torch.Tensor], nows,
               overlapped: Optional[bool] = None,
               snapshot_dir: Optional[str] = None,
               snapshot_start: int = 0) -> StepOutputs:
        """The streaming entry point: T periods through the sequential or
        the overlapped driver (``overlapped`` defaults to
        ``cfg.overlap_periods``; the two are bit-identical).

        With ``cfg.snapshot_every_periods > 0`` and a snapshot directory
        (``snapshot_dir``, else ``cfg.snapshot_dir``) the trace runs in
        chunks of that many periods with an asynchronous checkpoint of the
        whole state after each chunk, the last (possibly partial) one
        included. Checkpoint steps are global period indices offset by
        ``snapshot_start``. The chunked run equals the unchunked one bit
        for bit: ``checkpoint.save`` copies the state to the host before
        the next chunk writes the ring in place."""
        if overlapped is None:
            overlapped = self.cfg.overlap_periods
        run = self.run_periods_overlapped if overlapped else self.run_periods
        every = int(self.cfg.snapshot_every_periods)
        sdir = (snapshot_dir if snapshot_dir is not None
                else (self.cfg.snapshot_dir or None))
        if every <= 0 or sdir is None:
            return run(state, events, nows)
        from repro_torch.checkpoint import checkpoint as CKPT
        T = len(nows)
        outs, threads = [], []
        for lo in range(0, T, every):
            hi = min(lo + every, T)
            out = run(state, {k: v[lo:hi] for k, v in events.items()},
                      nows[lo:hi])
            state = out.state
            th = CKPT.save(state, sdir, step=int(snapshot_start) + hi,
                           keep=self.cfg.snapshot_keep, async_=True)
            threads.append(th)
            outs.append(out)
        for th in threads:
            th.join()
        if len(outs) == 1:
            return outs[0]
        return StepOutputs(
            state, torch.cat([o.enriched for o in outs]),
            torch.cat([o.flow_ids for o in outs]),
            torch.cat([o.mask for o in outs]),
            {k: torch.cat([o.metrics[k] for o in outs])
             for k in outs[0].metrics},
            None if outs[0].preds is None
            else torch.cat([o.preds for o in outs]))

    # -- convenience ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """The port's own knobs for this system: device, kernel backend,
        wire, the ingest event tile, the ring's bytes, the mesh (shards,
        flow home, pods, ports, the per-port and exchange capacities, the
        home node roster), the overlap and head switches, the snapshot and
        serving knobs, the fault spec and the re-homing collision policy.

        Left out, against the reference's ``describe()``: the TPU-only
        keys (``gather_variant``, ``ingest_variant``, ``ingest_vmem_bytes``,
        ``gather_vmem_bytes``, ``vmem_budget_bytes`` — VMEM budgets and
        the kernel variants they choose; the CUDA kernels have one
        variant each on this path) and ``tuning_registry`` (ROADMAP §1
        item 12)."""
        from repro_torch.kernels.ingest_update.kernel import clamp_tile
        cfg = self.cfg
        return {
            "device": str(self.device),
            "kernel_backend": self.backend,
            "wire_format": self.wire.name,
            "event_tile": clamp_tile(cfg.event_tile, cfg.event_block),
            "ring_region_bytes": cfg.ring_region_bytes(),
            "n_shards": self.n_shards,
            "flow_home": cfg.flow_home,
            "pods": self.mesh_pods,
            "shards_per_pod": self.shards_per_pod,
            "total_ports": self.total_ports,
            "ports_per_device": self.ports_per_device,
            "reporter_slots": self.rep_cfg.flows_per_shard,
            "port_report_capacity": self.port_capacity,
            "crosspod_exchange": self.crosspod_exchange,
            "crosspod_capacity": self.crosspod_capacity,
            "stage2_capacity": self.stage2_capacity,
            "home_nodes": self.home_nodes,
            "overlap_periods": cfg.overlap_periods,
            "inference_head": cfg.inference_head,
            "snapshot_every_periods": cfg.snapshot_every_periods,
            "snapshot_keep": cfg.snapshot_keep,
            "serve_offered_eps": cfg.serve_offered_eps,
            "serve_budget_us": cfg.serve_budget_resolved_us(),
            "serve_queue_events": cfg.serve_queue_events,
            "drop_policy": cfg.drop_policy,
            "fault_injection": (self.fault_spec.describe()
                                if self.fault_spec is not None else "none"),
            "rehome_collision_policy": cfg.rehome_collision_policy,
        }
