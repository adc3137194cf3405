"""The traced window: spans opened by the benchmark around calls into the
program's layers, a ``torch.profiler`` trace of the window, and what the
metric readers take from it.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<span>``.
Each file under ``spans/`` names one: a module attribute
(``{"module": ..., "attr": ...}``) or a method of the system under test
(``{"system": ...}``). They are put in place only for the traced window
and taken away after it.

From the exported Chrome trace: a device operation (kernel, memcpy,
memset) belongs to a span when the host call that launched it (same
correlation id) lies inside the span. The device's busy time is the
union of its operations' intervals inside the window.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import torch

HERE = Path(__file__).resolve().parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# copies between the host and the card: the copy engines and the host's
# memory, not the card's compute
TRANSFERS = ("Memcpy HtoD", "Memcpy DtoH")
WINDOW = "bench.window"


def span_specs() -> Dict[str, dict]:
    return {p.stem: json.loads(p.read_text())
            for p in sorted((HERE / "spans").glob("*.json"))}


def _ranged(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def spans_on(system):
    """Wrap every span's callable for the duration of the block."""
    undo = []
    for name, spec in span_specs().items():
        if "system" in spec:
            owner, attr = system, spec["system"]
        else:
            owner, attr = importlib.import_module(spec["module"]), \
                spec["attr"]
        own = attr in vars(owner)
        orig = getattr(owner, attr)
        setattr(owner, attr, _ranged(f"bench.{name}", orig))
        undo.append((owner, attr, orig, own))
    try:
        yield
    finally:
        for owner, attr, orig, own in reversed(undo):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)      # back to the class's method


def profiled(fn, on_card: bool) -> dict:
    """Run ``fn`` inside a ``bench.window`` range under torch.profiler;
    returns the parsed Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if on_card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _merged(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, times):
    """For each time (ascending), the name of the innermost range of
    ``ranges`` [(start, end, name)] that contains it, or None."""
    ranges = sorted(ranges)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class TraceSummary:
    """What the readers take from one traced window (times in µs)."""

    def __init__(self, trace: dict):
        evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
            else trace
        ann, launch, device, cpu_ops = [], {}, [], []
        for e in evs:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "user_annotation":
                ann.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = float(e["ts"])
            elif cat in DEVICE_CATS:
                device.append(e)
            elif cat == "cpu_op":
                cpu_ops.append(e)
        win = [e for e in ann if e["name"] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench.window range")
        w = win[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.window_us = self.t1 - self.t0
        tid = w.get("tid")
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in ann:
            if e["name"].startswith("bench.") and e["name"] != WINDOW:
                self.spans[e["name"][6:]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in self.spans.values():
            v.sort()
        inside = [e for e in device
                  if float(e["ts"]) < self.t1
                  and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.device_ops = inside
        self.launch = launch
        clipped = [(max(float(e["ts"]), self.t0),
                    min(float(e["ts"]) + float(e["dur"]), self.t1),
                    e["name"]) for e in inside]
        busy = _merged([(a, b) for a, b, _ in clipped])
        self.busy_us = sum(b - a for a, b in busy)
        self._busy = busy
        # the same union without the host-device transfers
        self.compute_busy_us = sum(b - a for a, b in _merged(
            [(a, b) for a, b, n in clipped if not n.startswith(TRANSFERS)]))
        self._cpu = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in cpu_ops if e.get("tid") == tid]
        self._ann = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in ann
                     if e["name"].startswith("bench.")
                     and e["name"] != WINDOW and e.get("tid") == tid]

    def _in_span(self, name: str, t: float) -> bool:
        """Spans of one name never overlap: the last one to start at or
        before ``t`` is the only candidate."""
        iv = self.spans.get(name, [])
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def _launched_in(self, span: str, kind):
        """The device operations of ``kind`` launched inside ``span``."""
        for e in self.device_ops:
            if e.get("cat") in kind:
                t = self.launch.get(e.get("args", {}).get("correlation"))
                if t is not None and self._in_span(span, t):
                    yield e

    def device_us(self, span: str, kind=DEVICE_CATS) -> float:
        """Device µs of the operations launched inside ``span``."""
        return sum(float(e["dur"]) for e in self._launched_in(span, kind))

    def count(self, span: str, kind=("kernel",)) -> int:
        """Device operations of ``kind`` launched inside ``span``."""
        return sum(1 for _ in self._launched_in(span, kind))

    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for e in self.device_ops:
            by[e["name"][:120]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10):
        """Idle device time summed by what the host was doing when each
        gap began: the innermost benchmark span and the innermost host
        operation."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [a for a, _ in gaps]
        spans = _innermost(self._ann, starts)
        ops = _innermost(self._cpu, starts)
        by = defaultdict(float)
        for (a, b), s, o in zip(gaps, spans, ops):
            label = (s[6:] if s else "outside spans") + " / " + \
                (o if o else "no host op")
            by[label[:120]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
