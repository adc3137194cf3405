"""Continuous online serving: the paper's sub-20 ms loop, closed (the port
of ``repro.launch.serving``).

    host trace-replay source (data.replay, paced at an offered rate)
        │ fixed-shape period batch (numpy)
        ▼
    HostIngestRing — two slots of pinned host buffers, copied to the card
        │             on a copy stream while the previous period computes
        ▼
    dfa_step per period (ingest, enrich, inference head)
        │
        ▼
    per-period wall latency against the SLO budget; p50/p99/p999;
    exact drop accounting; graceful drain; asynchronous snapshots.

Latency: one sample per period, on the host, from the step's dispatch to
the synchronisation on that period's outputs — the verdict latency a
consumer sees, the staging of the next period included. Percentiles are
``np.percentile``'s linear interpolation.

Backpressure: the source paces arrivals in virtual time (one budget per
period, deterministic), so offering faster than ``batch_events /
budget`` fills the host queue and the drop policy sheds events, with
exact accounting; wall-clock overruns are counted separately as SLO
``violations``.

The loop runs any system ``DFASystem`` builds, the emulated meshes
included: a period's batch is ``n_shards * event_block`` events, split
per port (per shard) by the pipeline.

Live recovery: a pod declared dead (by a ``Heartbeat`` roster, or the
``chaos`` hook) is absorbed between two periods without leaving
:meth:`ServingLoop.run`: restore the newest snapshot, rebuild on the
survivor mesh and re-home the dead pod's flows (``launch.elastic``),
re-feed the periods since the snapshot from the journal, and go on with
the pending batch. The journal holds each batch's recipe (the stream
positions it was assembled from, ``data.replay.BatchRecipe``), not the
batch: on the card a batch lives in a pinned staging slot that is
refilled two periods later, and copying every batch out would cost more
than the replay assembly itself. The stall is reported on its own
(``recovery_stall_us``), never among the per-period latencies.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import u32 as U
from repro_torch.data.replay import PeriodAccounting, TraceReplaySource
from repro_torch.launch import elastic as EL

_SHAPES = {"ts": (), "size": (), "five_tuple": (5,), "valid": ()}


def latency_summary(samples_us) -> Dict[str, float]:
    """p50/p99/p999 of per-period wall latencies (µs), linear-interp
    percentiles. ``count`` tells "no samples" (count 0, NaN percentiles —
    an explicit empty summary) from a real distribution, and shows a
    one-sample summary whose three percentiles coincide."""
    arr = np.asarray(list(samples_us), dtype=float)
    if arr.size == 0:
        return {"p50": float("nan"), "p99": float("nan"),
                "p999": float("nan"), "count": 0}
    p50, p99, p999 = np.percentile(arr, [50.0, 99.0, 99.9])
    return {"p50": float(p50), "p99": float(p99), "p999": float(p999),
            "count": int(arr.size)}


def host_tensors(batch: Dict[str, np.ndarray], now
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """A numpy batch as the (events, now) tensors ``dfa_step`` takes, on
    the CPU (u32 words as int32 bit patterns)."""
    ev = {k: (torch.from_numpy(np.ascontiguousarray(v)) if k == "valid"
              else U.from_numpy(v))
          for k, v in batch.items()}
    return ev, torch.tensor(int(now), dtype=torch.int64)


class HostIngestRing:
    """Double-buffered host -> device staging of period batches.

    On the card: two slots, used in turn, each a set of pinned host
    tensors (int32 views of the u32 words, bool validity, the period's
    ``now``) and device tensors of the same shapes. :meth:`stage` copies a
    slot's pinned buffers with ``non_blocking=True`` on a dedicated
    ``torch.cuda.Stream`` and makes the compute stream wait for that copy
    before anything later on it reads the slot. :meth:`consumed` records
    an event on the compute stream behind the step that read the slot; a
    slot's pinned buffers are refilled only after that event has
    completed (which also means its copy and its device buffers are
    done with). Staging never goes through pageable memory: the pinned
    buffers are checked when they are made.

    On the CPU the staged batch is plain tensors of the batch's arrays.
    The system's device decides which; there is no fallback between them.
    """

    def __init__(self, device, batch_events: int):
        self.device = torch.device(device)
        self.batch_events = int(batch_events)
        self.staged = 0
        self.on_card = self.device.type == "cuda"
        if not self.on_card:
            return
        N = self.batch_events
        self.copy_stream = torch.cuda.Stream(self.device)

        def slot(pin):
            bufs = {k: torch.empty((N,) + s, dtype=torch.bool if k == "valid"
                                   else torch.int32, pin_memory=pin,
                                   device=None if pin else self.device)
                    for k, s in _SHAPES.items()}
            bufs["now"] = torch.empty((), dtype=torch.int64, pin_memory=pin,
                                      device=None if pin else self.device)
            return bufs

        self._host = [slot(True), slot(True)]
        self._dev = [slot(False), slot(False)]
        for bufs in self._host:
            for k, t in bufs.items():
                if not t.is_pinned():
                    raise RuntimeError(f"staging buffer {k!r} is not pinned")
        # numpy views of the pinned buffers (u32 words as uint32)
        self._views = [{k: (t.numpy() if k == "valid"
                            else t.numpy().view(np.uint32))
                        for k, t in bufs.items() if k != "now"}
                       for bufs in self._host]
        self._consumed: List[Optional[torch.cuda.Event]] = [None, None]

    def host_slot(self) -> Optional[Dict[str, np.ndarray]]:
        """numpy views of the next slot's pinned buffers, to assemble a
        batch straight into (``TraceReplaySource.next_batch(out=...)``);
        waits until the slot is free. None on the CPU."""
        if not self.on_card:
            return None
        s = self.staged & 1
        if self._consumed[s] is not None:
            self._consumed[s].synchronize()
        return self._views[s]

    def stage(self, batch: Dict[str, np.ndarray], now
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Hand one period's batch to the device: (events, now) to pass to
        ``dfa_step``. On the card the copy is in flight when this
        returns; the compute stream waits for it."""
        if not self.on_card:
            self.staged += 1
            return host_tensors(batch, now)
        s = self.staged & 1
        views = self.host_slot()         # waits until the slot is free
        self.staged += 1
        host, dev = self._host[s], self._dev[s]
        for k, v in views.items():
            if batch[k] is not v:        # not assembled in place: copy in
                v[...] = batch[k]
        host["now"].fill_(int(now))
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            for k, t in host.items():
                dev[k].copy_(t, non_blocking=True)
        compute.wait_stream(self.copy_stream)
        return {k: dev[k] for k in _SHAPES}, dev["now"]

    def consumed(self) -> None:
        """Record, on the compute stream, that the step which read the
        most recently staged slot has been issued."""
        if self.on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._consumed[(self.staged - 1) & 1] = ev


@dataclasses.dataclass
class ServingReport:
    """What one :meth:`ServingLoop.run` produced."""

    periods: int                      # main-loop periods
    drained_periods: int              # extra periods run by the drain
    budget_us: int                    # the SLO
    offered: int
    processed: int
    dropped: int
    violations: int                   # periods with wall latency > SLO
    latency_us: List[float]           # one sample per period (incl drain)
    per_period: List[PeriodAccounting]
    last: object = dataclasses.field(default=None, repr=False)
    snapshots: int = 0                # asynchronous DFAState checkpoints
    # -- live in-loop recovery (its own bucket, NOT in latency_us: a
    # membership change is a planned stall, not a period's verdict) ----
    recoveries: int = 0               # dead pods absorbed mid-serve
    recovery_stall_us: List[float] = dataclasses.field(
        default_factory=list)         # wall stall per recovery
    duplicate_recovery_skips: int = 0  # re-trips for already-removed pods
    journal_replayed: int = 0         # journal periods re-fed on recovery
    # the port's own: per-period scalar metrics stacked under (periods,)
    # (device tensors, read after the run); the host's time per period
    # in µs by part — replay assembly, staging, step dispatch and the
    # wait for the period's outputs; per recovery, its stall in µs by
    # part — snapshot restore, survivor rebuild + re-home, journal replay
    metrics: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    host_us: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict, repr=False)
    recovery_us: List[Dict[str, float]] = dataclasses.field(
        default_factory=list, repr=False)

    @property
    def latency(self) -> Dict[str, float]:
        return latency_summary(self.latency_us)

    @property
    def balanced(self) -> bool:
        """The exact-accounting invariant (always true after a drain)."""
        return self.offered == self.processed + self.dropped

    @property
    def sustained_eps(self) -> float:
        """Events served per second of budgeted period time (0.0 for a
        zero-period run)."""
        total = self.periods + self.drained_periods
        if total == 0:
            return 0.0
        return self.processed / (total * self.budget_us / 1e6)


def build_source(system, events, nows=None,
                 batch_events: Optional[int] = None) -> TraceReplaySource:
    """A replay source wired to the system's serving knobs (the fields
    ``DFASystem.describe()`` reports)."""
    cfg = system.cfg
    return TraceReplaySource(
        events, nows,
        batch_events=batch_events or system.n_shards * cfg.event_block,
        offered_eps=cfg.serve_offered_eps,
        budget_us=cfg.serve_budget_resolved_us(),
        queue_events=cfg.serve_queue_events,
        drop_policy=cfg.drop_policy)


class ServingLoop:
    """The continuous period loop.

    Per iteration: dispatch ``dfa_step`` on the staged batch (the card
    runs it asynchronously), pull and stage the NEXT period's batch
    through the ingest ring while it runs, then wait for the step's
    outputs and take the latency sample. On shutdown the source stops
    offering arrivals and the loop runs until the host queue is empty,
    so every admitted event is processed or counted as dropped.

    Live recovery (module docstring): ``heartbeat`` (a
    ``distributed.monitor.Heartbeat`` with a roster) trips it when a
    whole pod is stale; ``chaos(t) -> pods to declare dead after period
    t`` is the test hook. Both name pods by their original index, which
    a recovery does not renumber. ``recovery_devices``: where the
    survivor system runs — one torch device, or a sequence of one (the
    system's own device by default)."""

    def __init__(self, system, source: TraceReplaySource,
                 budget_us: Optional[int] = None,
                 snapshot_dir: Optional[str] = None,
                 heartbeat=None,
                 chaos: Optional[Callable[[int], Sequence[int]]] = None,
                 recovery_devices=None):
        if source.batch_events % system.n_shards:
            raise ValueError(
                f"batch_events={source.batch_events} must divide across "
                f"{system.n_shards} shards")
        self.system = system
        self.source = source
        self.budget_us = int(budget_us
                             or system.cfg.serve_budget_resolved_us())
        self.ring = HostIngestRing(system.device, source.batch_events)
        self.snapshot_dir = (snapshot_dir if snapshot_dir is not None
                             else (system.cfg.snapshot_dir or None))
        self.snapshot_every = int(system.cfg.snapshot_every_periods)
        self.heartbeat = heartbeat
        self.chaos = chaos
        self.recovery_device = EL.one_device(recovery_devices, system.device)
        # (period index, batch recipe, now) of the last snapshot window's
        # batches: snapshot_every - 1 completed periods to re-feed at
        # worst, plus the pending batch
        self._journal: collections.deque = collections.deque(
            maxlen=max(self.snapshot_every, 1) + 1)
        # original pod ids still in the mesh, in mesh order; a second
        # declaration of a removed pod is a counted no-op
        self._live_pods: List[int] = list(range(system.mesh_pods))
        self._removed_pods: set = set()
        self._dup_skips = 0

    def _pull(self, split, idx: int):
        """Next batch from the source (journaled as consumed by period
        ``idx``), staged; host time into ``split``."""
        t0 = time.perf_counter()
        batch, now, acct = self.source.next_batch(out=self.ring.host_slot())
        self._journal.append((idx, self.source.last_recipe, now))
        t1 = time.perf_counter()
        staged = self.ring.stage(batch, now)
        split["replay"].append((t1 - t0) * 1e6)
        split["stage"].append((time.perf_counter() - t1) * 1e6)
        return staged, acct

    # -- live recovery ----------------------------------------------------

    def _dead_pods(self, t: int) -> List[int]:
        """Original pod ids newly declared dead after period ``t`` (chaos
        hook + whole-pod heartbeat trips), removed pods filtered out and
        counted."""
        declared: List[int] = []
        if self.chaos is not None:
            declared.extend(int(d) for d in self.chaos(t))
        if self.heartbeat is not None:
            declared.extend(EL.whole_dead_pods(self.heartbeat))
        fresh = []
        for d in dict.fromkeys(declared):       # de-dup, keep order
            if d in self._removed_pods:
                self._dup_skips += 1
            else:
                fresh.append(d)
        return fresh

    def _recover(self, dead_orig: int, t: int):
        """Absorb a dead pod after period ``t`` without leaving the loop:
        restore the newest snapshot, rebuild on the survivor mesh and
        re-home the dead pod's flows, then re-feed the journaled periods
        since the snapshot, each batch assembled again from its recipe.
        Returns (state, periods replayed, stall µs by part)."""
        pos = self._live_pods.index(dead_orig)  # current mesh position
        if self.snapshot_dir is None:
            raise RuntimeError(
                "live recovery needs snapshots: construct the loop with "
                "snapshot_dir (and cfg.snapshot_every_periods > 0) so a "
                "restore point exists inside the journal window")
        new_system, state, period = EL.recover_from_snapshot(
            self.system, self.snapshot_dir, pos,
            devices=self.recovery_device)
        if self.source.batch_events % new_system.n_shards:
            raise ValueError(
                f"batch_events={self.source.batch_events} does not "
                f"divide across the {new_system.n_shards} survivor "
                "shards")
        t0 = time.perf_counter()
        replayed = 0
        for idx, recipe, now in sorted(self._journal, key=lambda e: e[0]):
            if period < idx <= t:
                ev, dnow = host_tensors(self.source.rebuild(recipe), now)
                ev = {k: v.to(new_system.device) for k, v in ev.items()}
                state = new_system.dfa_step(
                    state, ev, dnow.to(new_system.device)).state
                replayed += 1
        if period + replayed != t:
            raise RuntimeError(
                f"journal window does not reach the snapshot: restored "
                f"period {period}, journal replayed {replayed} of the "
                f"{t - period} periods since — raise "
                "snapshot_every_periods/journal depth or snapshot more "
                "often")
        if new_system.device.type == "cuda":
            torch.cuda.synchronize(new_system.device)
        parts = {**new_system.last_recovery_us,
                 "replay": (time.perf_counter() - t0) * 1e6}
        self.system = new_system
        self._live_pods.pop(pos)
        self._removed_pods.add(dead_orig)
        if self.heartbeat is not None:
            self.heartbeat.retire_pod(dead_orig)
        return state, replayed, parts

    def _restage(self, staged):
        """The pending batch for the survivor system: the staged tensors
        as they are when it runs on the ring's device, else the batch
        assembled again from its recipe and staged on a new ring."""
        device = self.system.device
        if device == self.ring.device:
            return staged
        self.ring = HostIngestRing(device, self.source.batch_events)
        _, recipe, now = self._journal[-1]
        return self.ring.stage(self.source.rebuild(recipe), now)

    def run(self, periods: int, drain: bool = True,
            state=None) -> ServingReport:
        if periods < 0:
            raise ValueError("periods must be >= 0")
        if periods == 0:
            total = self.source.total
            return ServingReport(
                periods=0, drained_periods=0, budget_us=self.budget_us,
                offered=total.offered, processed=total.processed,
                dropped=total.dropped, violations=0, latency_us=[],
                per_period=[], last=None, snapshots=0)
        source = self.source
        if state is None:
            state = self.system.init_state()
        split = {k: [] for k in ("replay", "stage", "dispatch", "wait")}
        latencies: List[float] = []
        accounts: List[PeriodAccounting] = []
        period_metrics: List[Dict[str, torch.Tensor]] = []
        violations = drained = snapshots = 0
        snap_threads = []
        stalls: List[float] = []
        stall_parts: List[Dict[str, float]] = []
        replayed_total = 0
        dup0 = self._dup_skips
        snap_on = self.snapshot_every > 0 and self.snapshot_dir is not None
        if snap_on:
            from repro_torch.checkpoint import checkpoint as CKPT

        staged, acct = self._pull(split, 1)           # period 0
        t = 0
        while True:
            system = self.system
            accounts.append(acct)
            t0 = time.perf_counter()
            out = system.dfa_step(state, *staged)
            self.ring.consumed()
            done = None
            if system.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            t1 = time.perf_counter()
            split["dispatch"].append((t1 - t0) * 1e6)
            # pull + stage period t+1 while t computes
            t += 1
            if t >= periods and drain:
                source.begin_drain()                  # graceful shutdown
            has_next = t < periods or (drain and source.pending > 0)
            if has_next:
                staged, acct = self._pull(split, t + 1)
                if t >= periods:
                    drained += 1
            state = out.state
            t2 = time.perf_counter()
            if done is not None:
                done.synchronize()                    # period t-1 done
            t3 = time.perf_counter()
            split["wait"].append((t3 - t2) * 1e6)
            lat_us = (t3 - t0) * 1e6
            latencies.append(lat_us)
            if lat_us > self.budget_us:
                violations += 1
            period_metrics.append({k: v for k, v in out.metrics.items()
                                   if v.dim() == 0})
            if snap_on and (t % self.snapshot_every == 0 or not has_next):
                # the outputs are complete and the next step has not been
                # dispatched: save() copies the state to the host now (the
                # next step writes the ring in place), the IO rides a
                # thread. The final period always snapshots.
                snap_threads.append(CKPT.save(
                    state, self.snapshot_dir, step=t,
                    keep=system.cfg.snapshot_keep, async_=True))
                snapshots += 1
            # live recovery, between periods: the snapshot threads land
            # first so the newest restore point exists
            for dead in self._dead_pods(t):
                for th in snap_threads:
                    th.join()
                snap_threads.clear()
                stall0 = time.perf_counter()
                state, replayed, parts = self._recover(dead, t)
                if has_next:
                    staged = self._restage(staged)
                stalls.append((time.perf_counter() - stall0) * 1e6)
                stall_parts.append(parts)
                replayed_total += replayed
            if not has_next:
                break

        for th in snap_threads:
            th.join()
        total = source.total
        return ServingReport(
            periods=periods, drained_periods=drained,
            budget_us=self.budget_us,
            offered=total.offered, processed=total.processed,
            dropped=total.dropped, violations=violations,
            latency_us=latencies, per_period=accounts, last=out,
            snapshots=snapshots, recoveries=len(stalls),
            recovery_stall_us=stalls,
            duplicate_recovery_skips=self._dup_skips - dup0,
            journal_replayed=replayed_total,
            metrics={k: torch.stack([m[k] for m in period_metrics])
                     for k in period_metrics[0]},
            host_us=split, recovery_us=stall_parts)


def serve_trace(system, events, nows=None, periods: int = 100,
                drain: bool = True) -> ServingReport:
    """One-call serving run: replay ``events`` through the continuous
    loop for ``periods`` periods under the system's serving knobs."""
    source = build_source(system, events, nows)
    return ServingLoop(system, source).run(periods, drain=drain)
