"""Fault-tolerance runtime pieces (the port's own copy of
``repro.distributed.monitor``; pure Python): step watchdog, heartbeats,
retry loop.

* StepMonitor — EMA step-time tracker; flags stragglers (step > k× EMA) and
  raises after ``max_consecutive_slow`` (a hung collective on real fleets).
* Heartbeat — per-process liveness file ``hb_<index>.json`` holding the
  beat's wall time ``t``, its ``step`` and the process's ``pod``; the
  coordinator scans the peers' files. The format is the reference's, so
  a roster written by either package reads the same in the other.
* run_with_restart — wraps a step function with checkpoint-restore retry:
  on exception, restore latest checkpoint and replay (the step index comes
  from the checkpoint, and the data pipeline is step-keyed, so replay is
  exact).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Union


@dataclass
class StepMonitor:
    ema_decay: float = 0.9
    slow_factor: float = 3.0
    max_consecutive_slow: int = 5
    ema: Optional[float] = None
    consecutive_slow: int = 0
    slow_steps: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> Dict[str, float]:
        dt = time.monotonic() - self._t0
        slow = self.ema is not None and dt > self.slow_factor * self.ema
        if slow:
            self.consecutive_slow += 1
            self.slow_steps += 1
        else:
            self.consecutive_slow = 0
        self.ema = dt if self.ema is None else (
            self.ema_decay * self.ema + (1 - self.ema_decay) * dt)
        if self.consecutive_slow >= self.max_consecutive_slow:
            raise RuntimeError(
                f"straggler watchdog: {self.consecutive_slow} consecutive "
                f"slow steps (last {dt:.3f}s vs EMA {self.ema:.3f}s)")
        return {"step_time": dt, "ema": self.ema, "slow": float(slow)}


@dataclass
class Heartbeat:
    """Per-process liveness file; ``pod`` records which pod of the 2D
    (pod, shard) mesh the process serves, so the coordinator can tell a
    single straggler from a whole pod losing its ICI/power domain (the
    multi-pod stream can drain and re-home a pod's port set; a lone dead
    process is a restart).

    ``expected_peers`` registers the roster up front — either a mapping
    {process_index: pod} or an iterable of process indices (pod 0). A
    registered peer that has *never* written a beat file (died before its
    first beat, or its file is unreadable) is reported dead with
    ``age=inf``; without a roster such a process is invisible, which is
    fatal for the elastic pod-loss trigger."""
    directory: str
    process_index: int = 0
    stale_after_s: float = 60.0
    pod: int = 0
    expected_peers: Optional[Union[Dict[int, int], Iterable[int]]] = None
    # processes deliberately removed from the roster (a recovered-from
    # pod): they never beat again, and reporting them dead forever would
    # re-trip the pod-loss trigger on every scan
    retired: set = field(default_factory=set)

    def retire_peers(self, indices: Iterable[int]) -> None:
        """Stop reporting these processes as dead (post-recovery)."""
        self.retired.update(int(i) for i in indices)

    def retire_pod(self, pod: int) -> None:
        """Retire every registered process of ``pod`` (the elastic
        recovery path calls this after the survivor mesh is live)."""
        self.retire_peers(i for i, p in self._expected().items()
                          if p == pod)

    def beat(self, step: int):
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"hb_{self.process_index}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "t": time.time(), "pod": self.pod}, f)
        os.replace(tmp, path)

    def dead_peers(self) -> Dict[int, float]:
        """-> {process_index: seconds_since_last_beat} for stale peers."""
        return {idx: age for idx, (age, _pod)
                in self._stale().items()}

    def dead_peers_by_pod(self) -> Dict[int, Dict[int, float]]:
        """-> {pod: {process_index: seconds_since_last_beat}} for stale
        peers, grouped by the pod each peer recorded in its last beat
        (heartbeat files from before the pod field default to pod 0)."""
        out: Dict[int, Dict[int, float]] = {}
        for idx, (age, pod) in self._stale().items():
            out.setdefault(pod, {})[idx] = age
        return out

    def _expected(self) -> Dict[int, int]:
        if self.expected_peers is None:
            return {}
        if isinstance(self.expected_peers, dict):
            return {int(k): int(v) for k, v in self.expected_peers.items()}
        return {int(i): 0 for i in self.expected_peers}

    def _stale(self) -> Dict[int, tuple]:
        now = time.time()
        out: Dict[int, tuple] = {}
        seen: set = set()
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                if not name.startswith("hb_") or not name.endswith(".json"):
                    continue
                try:
                    idx = int(name[3:-5])
                    with open(os.path.join(self.directory, name)) as f:
                        d = json.load(f)
                    age = now - d["t"]
                except (json.JSONDecodeError, OSError, ValueError,
                        KeyError, TypeError):
                    # unparsable beat counts as never-beaten, not healthy
                    continue
                seen.add(idx)
                if age > self.stale_after_s and idx not in self.retired:
                    out[idx] = (age, int(d.get("pod", 0)))
        for idx, pod in self._expected().items():
            if idx not in seen and idx not in self.retired:
                out[idx] = (float("inf"), pod)
        return out


def run_with_restart(step_fn: Callable[[Any, int], Any], state: Any,
                     start_step: int, num_steps: int,
                     save_fn: Callable[[Any, int], None],
                     restore_fn: Callable[[], Any],
                     checkpoint_every: int = 50,
                     max_restarts: int = 3,
                     monitor: Optional[StepMonitor] = None,
                     on_metrics: Optional[Callable] = None):
    """Crash-tolerant training loop driver.

    Restore falls back to the caller's ``(state, start_step)`` when no
    checkpoint exists yet (a crash before the first save must count
    against ``max_restarts``, not escape as FileNotFoundError), and the
    final state is always saved on loop exit, so the tail
    ``num_steps % checkpoint_every`` steps survive a later process death.
    """
    restarts = 0
    step = start_step
    initial = (state, start_step)
    while step < num_steps:
        try:
            if monitor:
                monitor.start()
            state, metrics = step_fn(state, step)
            if monitor:
                metrics = {**metrics, **monitor.stop()}
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(state, step)
        except (RuntimeError, ValueError, FloatingPointError):
            restarts += 1
            if restarts > max_restarts:
                raise
            try:
                state, step = restore_fn()
            except FileNotFoundError:
                state, step = initial
            if monitor:
                monitor.consecutive_slow = 0
    save_fn(state, step)
    return state, step
