"""The DFA monitoring period on one shard, end to end (Fig 1).

One period is two half-steps:

  ``ingest_half``  reporter ingest of the packet events into the Table-I
                   registers -> due flows -> DTA reports -> routing ->
                   translator history addressing -> (optional transport
                   fault injection, ``data.faults``) -> checksum- and
                   seq-checked placement into the collector ring;
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

State tensors are updated in place where that saves memory: the
collector ring (84 MB at PAPER scale) is written by ring placement
directly, so a state passed into a step shares its ring with the state
that comes out.

The port runs one shard (``flow_home="ingest"``): the reference's
``all_to_all`` over one shard is the identity and ``psum``/``pmax`` are
identities; the formulas are kept so the multi-shard slice can fill them
in. What is not ported raises ``NotImplementedError`` naming its ROADMAP
item.
"""
from __future__ import annotations

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


def _global_seq_gap(coll_st: COLL.CollectorState, lseq0, recv0, lost0):
    """Replace the collector's shard-local seq-gap count with the global
    one. Per reporter, the window advance (max over shards; with one
    shard ``pmax`` is the identity) minus the accepted arrivals (summed
    over shards) is the number of reports that never landed. Returns
    (state', lost_delta)."""
    advanced = (U.wide(coll_st.last_seq).sum() - U.wide(lseq0).sum())
    arrivals = U.wide(coll_st.received) - U.wide(recv0)
    lost_delta = (advanced - arrivals) & U.MASK
    lost = U.narrow(U.wide(lost0) + lost_delta)
    return coll_st._replace(lost_reports=lost), lost_delta


def _delta(new, old) -> torch.Tensor:
    """u32 counter delta, wrap-safe."""
    return (U.wide(new) - U.wide(old)) & U.MASK


class DFASystem:
    """One shard of the DFA system on ``device`` (the CUDA card unless
    the caller asks for ``"cpu"``).

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
        if n_shards != 1:
            raise NotImplementedError(
                "more than one shard is ROADMAP §1 item 7 (multi-shard 1-D "
                "mesh); this slice runs one shard")
        if cfg.flow_home != "ingest":
            raise NotImplementedError(
                f"flow_home={cfg.flow_home!r} is ROADMAP §1 item 8 (2-D "
                "pod mesh); this slice runs flow_home='ingest'")
        self.wire = WIRE.resolve(cfg)
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self.n_shards = 1
        self.head = None
        if cfg.inference_head != "none":
            from repro_torch.models.flow_head import FlowHead
            self.head = FlowHead(cfg, device=device)
            if infer_params is not None:
                from repro_torch.convert import head_params_from_numpy
                head_params_from_numpy(self.head, infer_params)

    @property
    def fault_spec(self) -> Optional[FAULTS.FaultSpec]:
        """The armed transport-fault schedule, or None (no injection)."""
        fs = self.cfg.fault_spec
        return fs if fs is not None and fs.armed else None

    # -- state ------------------------------------------------------------
    def init_state(self) -> DFAState:
        return DFAState(REP.init_state(self.cfg, self.device),
                        TRANS.init_state(self.cfg, self.device),
                        COLL.init_state(self.cfg, self.device))

    # -- the two half-steps -----------------------------------------------
    def ingest_half(self, state: DFAState, events: Dict[str, torch.Tensor],
                    now, backend=None
                    ) -> Tuple[DFAState, RoutedBatch,
                               Dict[str, torch.Tensor]]:
        """Reporter ingest, due-flow reports, routing, translator
        addressing, the optional fault injector and ring placement.
        events: ts/size (E,), five_tuple (E, 5) (int32 bit patterns),
        valid (E,) bool; ``now`` a u32 value (int or 0-d tensor). Metrics
        are per-period deltas (int64 scalars); with faults armed they also
        hold the ``injected_*`` counts and the per-row fault ledger
        (``data.faults``). Drawing the fault schedule reads ``now`` on the
        host, which waits for the card when ``now`` lives there."""
        cfg = self.cfg
        b = backend or self.backend
        n = self.n_shards
        shard = 0
        flow_base = shard * cfg.flows_per_shard
        cap_out = max(1, cfg.report_capacity // n)
        rep_st, tr_st, coll_st = state
        collisions0 = rep_st.collisions
        bad0 = coll_st.bad_checksum
        anom0 = coll_st.seq_anomalies
        lost0 = coll_st.lost_reports
        # 1. reporter ingest
        rep_st = REP.ingest(rep_st, events, cfg, backend=b)
        # 2. due flows -> DTA reports, stamped with reporter id = shard
        slots, mask = REP.due_flows(rep_st, now, cfg, cfg.report_capacity)
        rep_st, reports = REP.make_reports(rep_st, slots, mask, now, 0,
                                           flow_base, cfg)
        wf = self.wire
        mw = wf.report_meta_word
        meta = wf.set_report_reporter(reports[:, mw], torch.full_like(
            reports[:, mw], shard % wf.n_reporters))
        reports[:, mw] = U.narrow(torch.where(mask, meta, 0))
        # 3. route to owner shards (the exchange over one shard is the
        # identity permutation)
        buckets, bmask, mis = TRANS.route_reports(
            reports, mask, n, cfg.flows_per_shard, cap_out)
        routed = buckets.reshape(n * cap_out, wf.report_words)
        rmask = bmask.reshape(n * cap_out)
        dropped = mask.sum() - bmask.sum() - mis
        # 4. owner-side translator: history addresses + RoCEv2 payloads
        tr_st, payloads, coords = TRANS.translate(tr_st, routed, rmask,
                                                  flow_base, cfg)
        # 5. collector ring placement, optionally through the lossy
        # transport: faults hit only what the collector sees; the routed
        # coordinates stay what the switch emitted
        ing_pay, ing_mask, fmetrics = payloads, rmask, {}
        if self.fault_spec is not None:
            ing_pay, ing_mask, fcounts, fledger = FAULTS.inject(
                payloads, rmask, self.fault_spec, wf, now, shard)
            fmetrics = {**fcounts, **fledger}
        lseq0, recv0 = coll_st.last_seq, coll_st.received
        coll_st = COLL.ingest(coll_st, ing_pay, ing_mask, flow_base, cfg,
                              backend=b)
        coll_st, lost_delta = _global_seq_gap(coll_st, lseq0, recv0, lost0)
        metrics = {
            "reports_sent": mask.sum(),
            "reports_recv": rmask.sum(),
            "bucket_drops": dropped,
            "misroutes": mis,
            "collisions": _delta(rep_st.collisions, collisions0),
            "bad_checksum": _delta(coll_st.bad_checksum, bad0),
            "seq_anomalies": _delta(coll_st.seq_anomalies, anom0),
            "lost_reports": lost_delta,
            **fmetrics,
        }
        return (DFAState(rep_st, tr_st, coll_st),
                RoutedBatch(coords["local_flow"], U.wide(routed[:, 0]),
                            rmask), metrics)

    def enrich_half(self, state: DFAState, routed: RoutedBatch,
                    backend=None):
        """Fused gather + enrichment of the routed flows (reads the ring,
        never writes it) plus the optional head. Returns (enriched (R, D),
        flow_ids (R,), mask (R,), preds or None)."""
        b = backend or self.backend
        enriched = COLL.enrich_flow_history(state.collector,
                                            routed.local_flow, self.cfg,
                                            mask=routed.mask, backend=b)
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
        wire, the ingest event tile, the ring's bytes, shards and flow
        home, the overlap and head switches, the snapshot and serving
        knobs and the fault spec.

        Left out, against the reference's ``describe()``: the TPU-only
        keys (``gather_variant``, ``ingest_variant``, ``ingest_vmem_bytes``,
        ``gather_vmem_bytes``, ``vmem_budget_bytes`` — VMEM budgets and
        the kernel variants they choose; the CUDA kernels have one
        variant each on this path), the 2-D mesh's (``pods``,
        ``shards_per_pod``, ``total_ports``, ``ports_per_device``,
        ``reporter_slots``, ``port_report_capacity``, ``crosspod_*``,
        ``stage2_capacity``: ROADMAP §1 item 8), the elastic knobs
        (``home_nodes``, ``rehome_collision_policy``: item 11) and
        ``tuning_registry`` (item 12)."""
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
        }
