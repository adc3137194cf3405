"""The plain reference of one DFA monitoring period, on one port or on the
emulated (pod, shard) mesh, in plain PyTorch (no hand-written kernel).

One period: every port ingests its slice of the period's events into its
Table-I registers (multipass), picks its due flows (most overdue first)
and emits DTA reports; the reports are routed to their home shard (on
the 2-D mesh: stage 1 by home shard, stage 2 by home pod, padded
buckets, then the home's canonical (flow, reporter, seq) order); the
home translator addresses them into the ring; the collector checks
checksum and sequence and places them (last write wins); then the
routed flows' histories are gathered and derived into ``derived_dim``
features, and the head turns them into logits.

The state keeps the global layout: reporter tables stacked per port,
translator and collector tables stacked per shard, scalar counters as
per-port / per-shard vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import collector as COLL
from . import enrich as ENR
from . import homes as HOMES
from . import ports as PORTS
from . import reporter as REP
from . import translator as TRANS
from . import u32 as U
from . import wire as WIRE

METRIC_KEYS = ("reports_sent", "reports_recv", "bucket_drops", "misroutes",
               "collisions", "bad_checksum", "seq_anomalies", "lost_reports")


class State(NamedTuple):
    reporter: REP.ReporterState
    translator: TRANS.TranslatorState
    collector: COLL.CollectorState


class Outputs(NamedTuple):
    """One period's outputs: (R, D) features, (R,) flow ids (0xFFFFFFFF
    on padding rows), (R,) mask, (R, C) logits or None, and the period's
    counters (int64 scalars)."""
    enriched: torch.Tensor
    flow_ids: torch.Tensor
    mask: torch.Tensor
    preds: Optional[torch.Tensor]
    metrics: Dict[str, torch.Tensor]


def _delta(new, old) -> torch.Tensor:
    return (U.wide(new).sum() - U.wide(old).sum()) & U.MASK


def head_logits(feats: torch.Tensor, params: Dict[str, torch.Tensor],
                dtype=torch.float32) -> torch.Tensor:
    """log1p-squashed features through the linear or one-hidden-layer
    ReLU head (weights in (in, out) layout), computed in ``dtype``."""
    x = torch.log1p(torch.abs(feats.to(torch.float32))).to(dtype)
    p = {k: v.to(dtype) for k, v in params.items()}
    if "w" in p:
        return (x @ p["w"] + p["b"]).to(torch.float32)
    h = torch.relu(x @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"]).to(torch.float32)


class RefSystem:
    """The reference system for ``cfg`` (a :class:`config.RefConfig`)
    over ``n_shards`` shards; ``head`` the head's parameters or None.
    ``dtype`` is the type the features and logits are computed in."""

    def __init__(self, cfg, n_shards: int, head=None, device="cpu",
                 dtype=torch.float32):
        self.cfg = cfg
        self.n = int(n_shards)
        self.head = head
        self.device = torch.device(device)
        self.dtype = dtype
        self.wire = WIRE.resolve(cfg)
        self.multipod = cfg.flow_home == "hash"
        if cfg.flow_home not in ("ingest", "hash"):
            raise ValueError(f"the reference runs flow_home 'ingest' and "
                             f"'hash', not {cfg.flow_home!r}")
        if self.multipod:
            self.pods = cfg.pods
            self.S = self.n // self.pods
            self.total_ports = cfg.pods * cfg.ports_per_pod \
                if cfg.ports_per_pod else self.n
            self.P_l = self.total_ports // self.n
            self.rep_cfg = dataclasses.replace(
                cfg, flows_per_shard=cfg.reporter_slots or
                cfg.flows_per_shard)
            self.R_p = cfg.port_report_capacity or max(
                1, cfg.report_capacity // self.total_ports)
            self.cap1 = max(1, self.P_l * self.R_p)
            self.cap2 = self.S * self.cap1
        else:
            self.total_ports = self.n
            self.rep_cfg = cfg

    def init_state(self) -> State:
        def tile(st, count):
            return type(st)(*(t.reshape(1).repeat(count) if t.dim() == 0
                              else t.repeat((count,) + (1,) * (t.dim() - 1))
                              for t in st))
        d = self.device
        return State(tile(REP.init_state(self.rep_cfg, d), self.total_ports),
                     tile(TRANS.init_state(self.cfg, d), self.n),
                     tile(COLL.init_state(self.cfg, d), self.n))

    def step(self, state: State, events: Dict[str, torch.Tensor], now,
             outputs: bool = True) -> Tuple[State, Outputs]:
        """One period. events: ts/size (P * E,), five_tuple (P * E, 5)
        (int32 bit patterns), valid bool, port-major; ``now`` a u32 value
        (int or 0-d tensor). ``outputs=False`` leaves the features and
        logits out (None): the state and counters are the same."""
        if not isinstance(now, torch.Tensor):       # no host-to-device copy
            now = torch.full((), int(now) & U.MASK, dtype=torch.int64,
                             device=self.device)
        if self.multipod:
            rep, routed, rmask, counts = self._ingest_mesh2d(
                state, events, now)
        else:
            rep, routed, rmask, counts = self._ingest_1d(state, events, now)
        state, lflow, metrics = self._home(state, rep, routed, rmask, counts)
        if not outputs:
            return state, Outputs(None, None, rmask.reshape(-1), None,
                                  {k: metrics[k] for k in METRIC_KEYS})
        return state, self._enrich(state, routed, rmask, lflow, metrics)

    def _ingest_1d(self, state, events, now):
        cfg, wf, n = self.cfg, self.wire, self.n
        F = cfg.flows_per_shard
        cap_out = max(1, cfg.report_capacity // n)
        rep = PORTS.ingest(state.reporter, events, cfg, n)
        gslots, mask = PORTS.due_flows(rep, now, cfg, n, cfg.report_capacity)
        rep, reports = PORTS.make_reports(rep, gslots, mask, now, cfg,
                                          gslots & U.MASK)
        buckets, bmasks = [], []
        sent = drops = mis = 0
        for s in range(n):
            bk, bm, mi = TRANS.route_reports(reports[s], mask[s], n, F,
                                             cap_out)
            buckets.append(bk)
            bmasks.append(bm)
            sent = sent + mask[s].sum()
            drops = drops + mask[s].sum() - bm.sum() - mi
            mis = mis + mi
        routed = torch.stack(buckets).transpose(0, 1).reshape(
            n, n * cap_out, wf.report_words)
        rmask = torch.stack(bmasks).transpose(0, 1).reshape(n, n * cap_out)
        counts = {"reports_sent": sent, "reports_recv": rmask.sum(),
                  "bucket_drops": drops, "misroutes": mis}
        return rep, routed, rmask, counts

    def _ingest_mesh2d(self, state, events, now):
        cfg, wf = self.cfg, self.wire
        n, S, pods = self.n, self.S, self.pods
        TP, P_l, R_p = self.total_ports, self.P_l, self.R_p
        fps, G, W = cfg.flows_per_shard, self.n * cfg.flows_per_shard, \
            wf.report_words
        rep = PORTS.ingest(state.reporter, events, self.rep_cfg, TP)
        gslots, masks = PORTS.due_flows(rep, now, self.rep_cfg, TP, R_p)
        fids = TRANS.home_flow_ids(rep.keys[gslots], G)
        rep, reports = PORTS.make_reports(rep, gslots, masks, now,
                                          self.rep_cfg, fids)
        reports = reports.view(n, P_l * R_p, W)
        masks = masks.view(n, P_l * R_p)

        def coords(fid):
            return TRANS.home_coords(fid, fps, S, n)
        b1, m1 = [], []
        drops = mis = 0
        for d in range(n):
            bk, bm, mi = TRANS.route_by_dest(
                reports[d], masks[d], coords(reports[d][:, 0])[1], S,
                self.cap1)
            b1.append(bk)
            m1.append(bm)
            drops = drops + masks[d].sum() - bm.sum() - mi
            mis = mis + mi
        r1 = torch.stack(b1).view(pods, S, S, self.cap1, W).transpose(
            1, 2).reshape(n, S * self.cap1, W)
        m1 = torch.stack(m1).view(pods, S, S, self.cap1).transpose(
            1, 2).reshape(n, S * self.cap1)
        b2, m2 = [], []
        for d in range(n):
            bk, bm, mi = TRANS.route_by_dest(
                r1[d], m1[d], coords(r1[d][:, 0])[0], pods, self.cap2)
            drops = drops + m1[d].sum() - bm.sum() - mi
            b2.append(bk)
            m2.append(bm)
            mis = mis + mi
        routed = torch.stack(b2).view(pods, S, pods, self.cap2, W).permute(
            2, 1, 0, 3, 4).reshape(n, pods * self.cap2, W)
        rmask = torch.stack(m2).view(pods, S, pods, self.cap2).permute(
            2, 1, 0, 3).reshape(n, pods * self.cap2)
        ordered = [TRANS.canonical_order(routed[d], rmask[d], wire=wf)
                   for d in range(n)]
        routed = torch.stack([o[0] for o in ordered])
        rmask = torch.stack([o[1] for o in ordered])
        counts = {"reports_sent": masks.sum(), "reports_recv": rmask.sum(),
                  "bucket_drops": drops, "misroutes": mis}
        return rep, routed, rmask, counts

    def _home(self, state, rep_st, routed, rmask, counts):
        cfg = self.cfg
        n = self.n
        counter, payloads, lflow = HOMES.translate(
            state.translator.hist_counter, routed, rmask, cfg)
        coll = HOMES.ingest(state.collector, payloads, rmask, cfg)
        pre = state.collector
        # a reporter's seqs fan out over the homes: per reporter the window
        # advance is the max over shards, the arrivals the sum; the lost
        # count lands on shard 0
        advanced = (U.wide(coll.last_seq).reshape(n, -1).amax(0).sum()
                    - U.wide(pre.last_seq).reshape(n, -1).amax(0).sum())
        arrivals = (U.wide(coll.received) - U.wide(pre.received)).sum()
        lost_delta = (advanced - arrivals) & U.MASK
        lead = torch.arange(n, device=lost_delta.device) == 0
        coll = coll._replace(lost_reports=U.narrow(
            U.wide(pre.lost_reports) + torch.where(lead, lost_delta, 0)))
        new = State(rep_st, TRANS.TranslatorState(counter), coll)
        metrics = {
            **counts,
            "collisions": _delta(rep_st.collisions,
                                 state.reporter.collisions),
            "bad_checksum": _delta(coll.bad_checksum, pre.bad_checksum),
            "seq_anomalies": _delta(coll.seq_anomalies, pre.seq_anomalies),
            "lost_reports": lost_delta,
        }
        return new, lflow, metrics

    def _enrich(self, state, routed, rmask, lflow, metrics) -> Outputs:
        n = self.n
        R = rmask.shape[1]
        mask = rmask.reshape(-1)
        enriched = torch.cat([ENR.gather_enrich(
            state.collector.memory[d * self.cfg.flows_per_shard:
                                   (d + 1) * self.cfg.flows_per_shard],
            state.collector.entry_valid[d * self.cfg.flows_per_shard:
                                        (d + 1) * self.cfg.flows_per_shard],
            lflow[d * R:(d + 1) * R], self.cfg,
            mask=mask[d * R:(d + 1) * R], dtype=self.dtype)
            for d in range(n)])
        flow_ids = torch.where(mask, U.wide(routed[:, :, 0]).reshape(-1),
                               WIRE.PAD_FLOW_ID)
        preds = None
        if self.head is not None:
            preds = head_logits(enriched, self.head, self.dtype)
            preds = torch.where(mask[:, None], preds, torch.zeros_like(preds))
        return Outputs(enriched, flow_ids, mask, preds,
                       {k: metrics[k] for k in METRIC_KEYS})
