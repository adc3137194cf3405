"""The entries a measured window drives, by the name a traffic mix gives
(``"entry"``), and what each hands the reference afterwards.

``serving_loop`` — ``repro_torch.launch.serving.ServingLoop.run`` over
the port's ``TraceReplaySource``: host replay of the trace (cycled and
re-timed onto the loop's clock), pinned staging, ``dfa_step`` per
period, and the wait for each period's verdicts. The window is two
``run`` calls back to back, sized so that they fill ``--seconds``; a
traced window is a third call that goes on from their state.

``stream`` — ``DFASystem.stream`` over a trace that lives in device
memory, one call per pass over the trace's periods. Between passes the
benchmark moves the trace onto the next pass's clock on the device
(timestamps and ``nows`` plus the trace's length). The window runs
passes until ``--seconds`` have passed and ends with one synchronize.

Both keep every period's counters, a sample of periods' outputs drawn
from the seed, and the state after the last period, and say which events
and ``now`` the reference gives period ``k`` (:meth:`inputs`).
"""
from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

_MASK = 0xFFFFFFFF


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Driver:
    def __init__(self, system, mix: Dict, events, nows, seed: int):
        self.system = system
        self.mix = mix
        self.device = system.device
        self.T = int(mix["trace_periods"])
        self.period_us = int(mix["period_us"])
        self.rng = random.Random(int(seed))
        self.sampled: Dict[int, tuple] = {}
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.state = None
        self.n_periods = 0          # periods in the measured window
        self.n_traced = 0           # periods in the traced window
        self.window_s = 0.0
        self.vectors = None
        self.traced_vectors = None  # vectors of the traced periods
        self.marks: List[tuple] = []    # (host seconds into the window,
                                        #  periods dispatched by then)

    @property
    def periods(self) -> int:
        return self.n_periods + self.n_traced

    def period_metrics(self, key: str) -> torch.Tensor:
        return torch.cat([m[key].reshape(-1) for m in self.metrics])

    def profile(self, parts: int = 10) -> List[float]:
        """Vectors a second in each of ``parts`` equal stretches of the
        measured window, each period counted in the stretch in which the
        host dispatched it (the card runs a period or two behind)."""
        recv = self.period_metrics("reports_recv")[:self.n_periods].tolist()
        per = [0] * parts
        done = 0
        for t, k in self.marks:
            k = min(k, self.n_periods)
            i = min(parts - 1, int(t * parts / self.window_s))
            per[i] += sum(recv[done:k])
            done = max(done, k)
        return [v * parts / self.window_s for v in per]

    def inputs(self, k: int, trace, nows):
        """The events and ``now`` the reference gives period ``k``."""
        return INPUTS[self.mix["entry"]](self.mix, k, trace, nows)

    def trace_period(self, k: int) -> int:
        """The trace period whose events period ``k`` carries."""
        return k % self.T


class ServingLoopDriver(_Driver):
    """The served path (module docstring). The reference's inputs follow
    the source's contract at line rate: period ``k`` takes the next
    ``batch`` events of the cycled trace, timestamps ``k * budget +
    i * budget // batch`` and ``now = (k + 1) * budget``."""

    def __init__(self, system, mix, events, nows, seed):
        super().__init__(system, mix, events, nows, seed)
        from repro_torch.data.replay import TraceReplaySource
        from repro_torch.launch.serving import ServingLoop
        self.budget = self.period_us       # one period's budget
        self.batch = int(events["ts"].shape[1])

        def source(ev):        # line rate, no host queue
            return TraceReplaySource(
                ev, batch_events=self.batch, offered_eps=0.0,
                budget_us=self.budget, queue_events=0,
                drop_policy="newest")
        self.loop = ServingLoop(system, source(events), budget_us=self.budget)
        self._warm = ServingLoop(system, source({k: v[:1] for k, v in
                                                 events.items()}),
                                 budget_us=self.budget)
        self._k = 0
        self._keep = set()
        orig = system.dfa_step

        def step(state, ev, now, backend=None):
            out = orig(state, ev, now, backend)
            if self._k in self._keep:
                self.sampled[self._k] = (out.enriched, out.flow_ids,
                                         out.mask, out.preds)
            self._k += 1
            self.marks.append((time.perf_counter() - self.t_start, self._k))
            return out
        self._step = step

    def warm(self) -> None:
        rep = self._warm.run(int(self.mix["warm_periods"]), drain=False,
                             state=self.system.init_state())
        _sync(self.device)
        # the later half of the warm-up, past the first periods' allocation
        lat = sorted(rep.latency_us[len(rep.latency_us) // 2:])
        self.period_est_us = lat[len(lat) // 2]
        self._warm = None

    def window(self, seconds: float) -> None:
        """Two ``run`` calls back to back: the first for half the window
        at the warm-up's period time, the second for what its own period
        time puts in the rest."""
        N1 = max(1, math.ceil(seconds * 0.5e6 / self.period_est_us))
        half = int(self.mix["sampled_periods"]) // 2
        # the periods whose outputs are compared: half of the sample in
        # each call, drawn from the seed
        self._keep = set(self.rng.sample(range(N1), min(N1, half)))
        self.system.dfa_step = self._step
        state = self.system.init_state()
        _sync(self.device)
        self.t_start = time.perf_counter()
        reps = [self.loop.run(N1, drain=False, state=state)]
        t1 = time.perf_counter() - self.t_start
        N2 = max(1, round((seconds - t1) * N1 / t1))
        N = N1 + N2
        self._keep |= set(self.rng.sample(range(N1, N), min(N2, half))) \
            | {N - 1}
        reps.append(self.loop.run(N2, drain=False, state=reps[0].last.state))
        self.window_s = time.perf_counter() - self.t_start
        self.n_periods = N
        self.host_us = {k: reps[0].host_us[k] + reps[1].host_us[k]
                        for k in reps[0].host_us}
        self.latency_us = reps[0].latency_us + reps[1].latency_us
        self.metrics += [r.metrics for r in reps]
        self.state = reps[1].last.state
        self.vectors = sum(r.metrics["reports_recv"].sum() for r in reps)

    def traced(self) -> None:
        M = int(self.mix["traced_periods"])
        rep = self.loop.run(M, drain=False, state=self.state)
        self.n_traced = M
        self.traced_vectors = rep.metrics["reports_recv"].sum()
        self.metrics.append(rep.metrics)
        self.state = rep.last.state


class StreamDriver(_Driver):
    """The direct path (module docstring)."""

    def __init__(self, system, mix, events, nows, seed):
        super().__init__(system, mix, events, nows, seed)
        self.events = events
        self.nows = nows.clone()
        self.shift = self.T * self.period_us

    def warm(self) -> None:
        n = int(self.mix["warm_periods"])
        self.system.stream(self.system.init_state(),
                           {k: v[:n] for k, v in self.events.items()},
                           self.nows[:n])
        _sync(self.device)

    def _pass(self) -> None:
        t = time.perf_counter()
        out = self.system.stream(self.state, self.events, self.nows)
        self.dispatch_s += time.perf_counter() - t
        self.state = out.state
        self.metrics.append(out.metrics)
        j = self.rng.randrange(self.T)
        self.sampled[self.passes * self.T + j] = tuple(
            None if x is None else x[j].clone()
            for x in (out.enriched, out.flow_ids, out.mask, out.preds))
        self._vectors = self._vectors + out.metrics["reports_recv"].sum()
        # the next pass's clock, on the device
        self.events["ts"].add_(self.shift)
        self.nows.add_(self.shift)
        self.passes += 1
        self.marks.append((time.perf_counter() - self.t_start,
                           self.passes * self.T))

    def window(self, seconds: float) -> None:
        self.state = self.system.init_state()
        self._vectors = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self.passes, self.dispatch_s = 0, 0.0
        _sync(self.device)
        self.t_start = time.perf_counter()
        while time.perf_counter() - self.t_start < seconds:
            self._pass()
        _sync(self.device)
        self.window_s = time.perf_counter() - self.t_start
        self.vectors = self._vectors
        self.n_periods = self.passes * self.T
        self.dispatch_us = self.dispatch_s * 1e6 / self.n_periods

    def traced(self) -> None:
        n = int(self.mix["traced_passes"])
        before = self._vectors
        for _ in range(n):
            self._pass()
        self.n_traced = n * self.T
        self.traced_vectors = self._vectors - before


def _i32(x: torch.Tensor) -> torch.Tensor:
    return (((x & _MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def served_inputs(mix, k: int, trace, nows):
    """Period ``k`` of the served path, as the replay source makes it at
    line rate: the next batch (one trace period's events) of the cycled
    trace, timestamps ``k * budget + i * budget // batch``, ``now = (k +
    1) * budget``."""
    budget = int(mix["period_us"])
    T, B = trace["ts"].shape
    L = T * B
    pos = (k * B + torch.arange(B, device=trace["ts"].device)) % L
    ev = {key: v.reshape((L,) + tuple(v.shape[2:]))[pos]
          for key, v in trace.items()}
    off = (torch.arange(B, device=pos.device, dtype=torch.int64)
           * budget) // B
    ev["ts"] = _i32(k * budget + off)
    return ev, ((k + 1) * budget) & _MASK


def stream_inputs(mix, k: int, trace, nows):
    """Period ``k`` of the direct path: trace period ``k % T`` moved ``k //
    T`` passes later (timestamps and ``now`` plus the trace's length)."""
    T = int(mix["trace_periods"])
    shift = (k // T) * T * int(mix["period_us"])
    ev = {key: v[k % T] for key, v in trace.items()}
    ev["ts"] = _i32(ev["ts"].to(torch.int64) + shift)
    return ev, (int(nows[k % T]) + shift) & _MASK


ENTRIES = {"serving_loop": ServingLoopDriver, "stream": StreamDriver}
INPUTS = {"serving_loop": served_inputs, "stream": stream_inputs}
