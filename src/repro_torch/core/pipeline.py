"""The DFA monitoring period on one shard, end to end (Fig 1).

One period is two half-steps:

  ``ingest_half``  reporter ingest of the packet events into the Table-I
                   registers -> due flows -> DTA reports -> routing ->
                   translator history addressing -> checksum- and
                   seq-checked placement into the collector ring;
  ``enrich_half``  fused history gather + feature derivation of the
                   routed flows into (R, derived_dim) f32 features, plus
                   the optional immediate-inference head.

``run_periods`` streams T periods. The three hot stages are the CUDA
kernels ``ingest_segment_sums``, ``ring_scatter`` and ``gather_enrich``
on the card and their plain PyTorch versions on the CPU
(``repro_torch.kernels.dispatch``); everything around them is torch ops.

State tensors are updated in place where that saves memory: the
collector ring (84 MB at PAPER scale) is written by ring placement
directly, so a state passed into a step shares its ring with the state
that comes out.

This slice runs one shard (``flow_home="ingest"``): the reference's
``all_to_all`` over one shard is the identity and ``psum``/``pmax`` are
identities; the formulas are kept so the multi-shard slice can fill them
in. What is not in the slice raises ``NotImplementedError`` naming its
ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import collector as COLL
from repro_torch.core import reporter as REP
from repro_torch.core import translator as TRANS
from repro_torch.core import wire as WIRE
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
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DFASystem runs on the CUDA card by default and this host "
                "has none; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
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
        if cfg.fault_spec is not None and getattr(cfg.fault_spec, "armed",
                                                  True):
            raise NotImplementedError(
                "an armed fault_spec is ROADMAP §1 item 9 (fault "
                "injection)")
        self.wire = WIRE.resolve(cfg)
        if self.wire.name != "v1":
            raise NotImplementedError(
                f"wire_format={self.wire.name!r} on the pipeline arrives "
                "with ROADMAP §1 item 8 (2-D mesh + V2)")
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
        addressing and ring placement. events: ts/size (E,), five_tuple
        (E, 5) (int32 bit patterns), valid (E,) bool; ``now`` a u32 value.
        Metrics are per-period deltas (int64 scalars)."""
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
        # 5. collector ring placement
        lseq0, recv0 = coll_st.last_seq, coll_st.received
        coll_st = COLL.ingest(coll_st, payloads, rmask, flow_base, cfg,
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
    def run_periods(self, state: DFAState, events: Dict[str, torch.Tensor],
                    nows, backend=None) -> StepOutputs:
        """Stream T periods. events: dict of (T, E, ...) tensors; nows:
        (T,) u32 values. Per-period fields come back stacked under (T,)."""
        outs = []
        for t in range(len(nows)):
            out = self.dfa_step(state, {k: v[t] for k, v in events.items()},
                                nows[t], backend)
            state = out.state
            outs.append(out)
        metrics = {k: torch.stack([o.metrics[k] for o in outs])
                   for k in METRIC_KEYS}
        preds = (None if outs[0].preds is None
                 else torch.stack([o.preds for o in outs]))
        return StepOutputs(state,
                           torch.stack([o.enriched for o in outs]),
                           torch.stack([o.flow_ids for o in outs]),
                           torch.stack([o.mask for o in outs]),
                           metrics, preds)

    def stream(self, state: DFAState, events: Dict[str, torch.Tensor], nows,
               overlapped: Optional[bool] = None) -> StepOutputs:
        """The streaming entry point; this slice has the sequential driver
        only."""
        if overlapped is None:
            overlapped = self.cfg.overlap_periods
        if overlapped:
            raise NotImplementedError(
                "the overlapped driver is ROADMAP §1 item 6 "
                "(run_periods_overlapped); use overlapped=False")
        return self.run_periods(state, events, nows)
