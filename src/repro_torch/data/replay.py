"""Trace-replay source for the continuous serving loop (the port of
``repro.data.replay``; numpy only, host arrays out).

:class:`TraceReplaySource` flattens a pre-built trace into one endless
host event stream and re-offers it at a configurable rate, with the
host-queue semantics of a real ingest boundary: a bounded carry-over
queue, a drop policy when arrivals outrun it, and exact per-period
accounting.

Arrival pacing is virtual-time: every serving period is taken to last
exactly one budget, so ``offered_eps`` events/second are
``offered_eps * budget_us / 1e6`` arrivals per period (fractional
remainders carry). Offering faster than ``batch_events / budget_us``
grows the queue and forces drops.

Accounting contract:

* every period: ``offered == admitted_to_queue + dropped`` and the queue
  never exceeds ``queue_events``;
* with ``queue_events == 0``: ``offered == processed + dropped`` per
  period;
* cumulatively ``offered == processed + dropped + queued``, and after
  :meth:`begin_drain` plus draining batches ``offered == processed +
  dropped``.

Drop policies: ``"newest"`` tail-drops the just-arrived events;
``"oldest"`` evicts queued events to admit the new ones.

The reference keeps its stream and queue as Python lists of per-event
tuples, which at 2^20 events per period is millions of Python objects
per period. This copy gives the same batches, ``now`` values and
accounting for every policy and rate, but holds the queue as runs of
consecutive positions in the cyclic stream, (start, length) pairs, and
assembles each batch with slices: arrivals are always the next events
of the stream, so the queue is a few such runs, never per-event objects.

The same runs are a batch's recipe: :attr:`TraceReplaySource.last_recipe`
names the stream positions, the event count and the period of the batch
``next_batch`` just made, and :meth:`TraceReplaySource.rebuild` makes
that batch again, into fresh arrays. The serving loop's recovery journal
keeps recipes, not batches: a batch assembled into a reused staging
buffer is gone once the buffer is refilled.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

DROP_POLICIES = ("newest", "oldest")


class PeriodAccounting(NamedTuple):
    """Exact event bookkeeping for one serving period."""

    offered: int        # events that arrived this period
    processed: int      # valid events placed into this period's batch
    dropped: int        # events shed by the drop policy this period
    queued: int         # events still waiting in the host queue after


def _host(a) -> np.ndarray:
    """numpy, or a torch tensor (u32 words as int32 bit patterns) read as
    numpy uint32 / bool — without importing torch."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


class BatchRecipe(NamedTuple):
    """What one batch was assembled from: runs (start, length) of
    positions in the cyclic stream, the number of valid events, and the
    period whose window the timestamps were put on."""

    runs: Tuple[Tuple[int, int], ...]
    n: int
    period: int


class _RunQueue:
    """A FIFO of stream positions held as runs (start, length)."""

    def __init__(self):
        self._runs: collections.deque = collections.deque()
        self.size = 0

    def push(self, start: int, n: int) -> None:
        if n <= 0:
            return
        if self._runs and sum(self._runs[-1]) == start:
            s, m = self._runs.pop()
            self._runs.append((s, m + n))
        else:
            self._runs.append((start, n))
        self.size += n

    def pop_front(self, n: int) -> list:
        """Remove and return the first ``n`` positions as runs."""
        out = []
        while n > 0 and self._runs:
            s, m = self._runs.popleft()
            k = min(n, m)
            out.append((s, k))
            if k < m:
                self._runs.appendleft((s + k, m - k))
            n -= k
            self.size -= k
        return out

    def drop_back(self, n: int) -> None:
        while n > 0 and self._runs:
            s, m = self._runs.pop()
            k = min(n, m)
            if k < m:
                self._runs.append((s, m - k))
            n -= k
            self.size -= k


class TraceReplaySource:
    """Replays a stacked trace as a paced, queued host event stream.

    Parameters
    ----------
    events, nows:
        A ``period_batches``-shaped trace: dict of ``(T, N, ...)`` arrays
        (keys ts/size/five_tuple/valid), numpy or torch. ``nows`` is not
        read: serving re-times events onto its own period clock, and the
        trace is cycled forever.
    batch_events:
        N — the fixed event-batch size the pipeline consumes per period.
    offered_eps:
        Offered rate in events/second; 0 means line rate (one full batch
        per period, no queueing, no drops).
    budget_us:
        The period budget used for virtual-time pacing and re-timing.
    queue_events:
        Host carry-over queue capacity, on top of the in-flight batch.
    drop_policy:
        ``"newest"`` | ``"oldest"``.
    """

    def __init__(self, events: Dict, nows=None, *, batch_events: int,
                 offered_eps: float = 0.0, budget_us: int = 20_000,
                 queue_events: int = 0, drop_policy: str = "newest"):
        if drop_policy not in DROP_POLICIES:
            raise ValueError(f"unknown drop_policy {drop_policy!r}; "
                             f"known: {list(DROP_POLICIES)}")
        if batch_events <= 0:
            raise ValueError("batch_events must be positive")
        if offered_eps < 0:
            raise ValueError("offered_eps must be >= 0")
        ts = _host(events["ts"])
        if ts.ndim != 2:
            raise ValueError(
                f"expected a stacked (T, N, ...) trace, got ts shape "
                f"{ts.shape}")
        valid = _host(events["valid"]).reshape(-1).astype(bool)
        # one host stream of the real events, in trace order
        self._five = np.ascontiguousarray(
            _host(events["five_tuple"]).reshape(-1, 5)[valid],
            dtype=np.uint32)
        self._size = np.ascontiguousarray(
            _host(events["size"]).reshape(-1)[valid], dtype=np.uint32)
        if len(self._size) == 0:
            raise ValueError("trace has no valid events to replay")
        self.batch_events = int(batch_events)
        self.offered_eps = float(offered_eps)
        self.budget_us = int(budget_us)
        self.queue_events = int(queue_events)
        self.drop_policy = drop_policy
        self._cursor = 0                 # absolute position in the stream
        self._acc = 0.0                  # fractional-arrival carry
        self._queue = _RunQueue()
        self._period = 0
        self._draining = False
        self.total = PeriodAccounting(0, 0, 0, 0)
        self.last_recipe: Optional[BatchRecipe] = None
        N = self.batch_events
        # each period's timestamps are t0 + these offsets (mod 2^32)
        self._ts_off = ((np.arange(N, dtype=np.uint64) * self.budget_us)
                        // N).astype(np.uint32)

    # -- the paced stream --------------------------------------------------

    def _arrivals_this_period(self) -> int:
        if self._draining:
            return 0
        if self.offered_eps == 0.0:      # line rate: one batch, no queue
            return self.batch_events
        self._acc += self.offered_eps * self.budget_us / 1e6
        n = int(self._acc)
        self._acc -= n
        return n

    def next_batch(self, out: Optional[Dict[str, np.ndarray]] = None
                   ) -> Tuple[Dict[str, np.ndarray], np.uint32,
                              PeriodAccounting]:
        """One serving period: admit arrivals, apply the drop policy,
        dequeue up to ``batch_events`` into a fixed-shape batch (short
        periods pad with ``valid=False`` rows), and account exactly.
        ``out``: arrays to assemble the batch into (ts/size (N,) uint32,
        five_tuple (N, 5) uint32, valid (N,) bool), e.g. views of pinned
        staging buffers; fresh arrays otherwise."""
        offered = self._arrivals_this_period()
        start = self._cursor
        self._cursor += offered
        dropped = 0
        if self.offered_eps == 0.0 and not self._draining:
            # line rate bypasses the queue entirely: batch == arrivals
            pending = [(start, offered)] if offered else []
        else:
            # room = carry-over queue + the one in-flight batch
            room = self.queue_events + self.batch_events
            self._queue.push(start, offered)
            excess = self._queue.size - room
            if excess > 0:
                dropped = excess
                if self.drop_policy == "newest":
                    self._queue.drop_back(excess)
                else:                    # "oldest": evict the head
                    self._queue.pop_front(excess)
            pending = self._queue.pop_front(self.batch_events)
        processed = sum(n for _, n in pending)
        self.last_recipe = BatchRecipe(tuple(pending), processed,
                                       self._period)
        batch = self._assemble(self.last_recipe, out)
        now = np.uint32(((self._period + 1) * self.budget_us)
                        & 0xFFFFFFFF)
        self._period += 1
        acct = PeriodAccounting(offered, processed, dropped,
                                self._queue.size)
        self.total = PeriodAccounting(
            self.total.offered + offered,
            self.total.processed + processed,
            self.total.dropped + dropped,
            self._queue.size)
        return batch, now, acct

    def rebuild(self, recipe: BatchRecipe) -> Dict[str, np.ndarray]:
        """The batch ``recipe`` describes, assembled again into fresh
        arrays: equal to the one ``next_batch`` returned for it."""
        return self._assemble(recipe, None)

    def _assemble(self, recipe: BatchRecipe, out) -> Dict[str, np.ndarray]:
        runs, n = recipe.runs, recipe.n
        N = self.batch_events
        if out is None:
            out = {"ts": np.empty(N, np.uint32),
                   "size": np.empty(N, np.uint32),
                   "five_tuple": np.empty((N, 5), np.uint32),
                   "valid": np.empty(N, bool)}
        five, size, valid = out["five_tuple"], out["size"], out["valid"]
        L = len(self._size)
        i = 0
        for s, m in runs:                # copy each run, wrapping at L
            while m > 0:
                p = s % L
                k = min(m, L - p)
                five[i:i + k] = self._five[p:p + k]
                size[i:i + k] = self._size[p:p + k]
                i, s, m = i + k, s + k, m - k
        five[n:] = 0
        size[n:] = 0
        valid[:n] = True
        valid[n:] = False
        # re-time onto the serving period window, evenly spaced in
        # arrival order (the reporter contract: sorted within a period)
        t0 = np.uint32((recipe.period * self.budget_us) & 0xFFFFFFFF)
        np.add(self._ts_off, t0, out=out["ts"])      # wraps mod 2^32
        return out

    # -- graceful shutdown -------------------------------------------------

    def begin_drain(self) -> None:
        """Stop offering new arrivals; later batches flush the queue.
        Once :attr:`pending` is 0, ``total.offered == total.processed +
        total.dropped`` exactly."""
        self._draining = True

    @property
    def pending(self) -> int:
        """Events still queued on the host (0 once drained)."""
        return self._queue.size
