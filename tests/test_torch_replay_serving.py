"""The port's replay source and serving loop against the JAX reference.

``TraceReplaySource``: the port holds its queue as runs of stream
positions instead of per-event tuples; it must give the reference's
batches, ``now`` values and accounting period by period — at line rate,
under rate, over rate with and without a queue, under both drop
policies, through a drain — and refuse what the reference refuses.
``latency_summary``: known samples, empty, one sample. ``serve_trace``
and ``ServingLoop`` on the CPU against the reference's on a 1x1 mesh:
the same accounting and the same end state. Also the zero-period run,
the run without a drain, and the refusals (indivisible batch; a
recovery without snapshots).
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_dfa_config
from repro.core.pipeline import DFASystem as JSystem
from repro.data import packets as JPK
from repro.data.replay import TraceReplaySource as JSource
from repro.launch import serving as JSERVE
from repro_torch.configs import REDUCED
from repro_torch.core.pipeline import DFASystem
from repro_torch.data import packets as PK
from repro_torch.data.replay import TraceReplaySource
from repro_torch.distributed.monitor import Heartbeat
from repro_torch.launch import serving as SERVE
from test_torch_pipeline import assert_state_equal

E = 64
CAP_EPS = E / (20_000 / 1e6)        # the batch-capacity rate


def trace(T=3, E_=128, n_flows=16, seed=1):
    return (JPK.period_batches(1, T, E_, n_flows=n_flows, flow_seed=seed),
            PK.period_batches(1, T, E_, n_flows=n_flows, flow_seed=seed))


def both_sources(T=3, **kw):
    (jev, jnows), (tev, tnows) = trace(T=T)
    kw.setdefault("batch_events", E)
    kw.setdefault("budget_us", 20_000)
    return JSource(jev, jnows, **kw), TraceReplaySource(tev, tnows, **kw)


def assert_same_periods(js, ts, periods, drain_after=None):
    for p in range(periods):
        if p == drain_after:
            js.begin_drain()
            ts.begin_drain()
        jb, jnow, jacct = js.next_batch()
        tb, tnow, tacct = ts.next_batch()
        assert tuple(jacct) == tuple(tacct), p
        assert int(jnow) == int(tnow) and tnow.dtype == np.uint32
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=f"{p}:{k}")
            assert jb[k].dtype == tb[k].dtype, k
        assert js.total == ts.total and js.pending == ts.pending


@pytest.mark.parametrize("case,kw,periods,drain_after", [
    ("line rate", {}, 6, None),
    ("under rate", {"offered_eps": 0.4 * CAP_EPS}, 6, None),
    ("fractional rate", {"offered_eps": 3_225.0,
                         "queue_events": 1 << 20}, 12, None),
    ("over rate, no queue, newest", {"offered_eps": 2 * CAP_EPS}, 5, None),
    ("over rate, no queue, oldest", {"offered_eps": 2 * CAP_EPS,
                                     "drop_policy": "oldest"}, 5, None),
    ("over rate, queue, newest", {"offered_eps": 2.5 * CAP_EPS,
                                  "queue_events": 96}, 12, 6),
    ("over rate, queue, oldest", {"offered_eps": 2.5 * CAP_EPS,
                                  "queue_events": 96,
                                  "drop_policy": "oldest"}, 12, 6),
    ("cycles the trace", {"offered_eps": 7 * CAP_EPS,
                          "queue_events": 300}, 9, 7),
    ("line rate, drained", {}, 4, 2),
])
def test_replay_matches_jax(case, kw, periods, drain_after):
    js, ts = both_sources(**kw)
    assert_same_periods(js, ts, periods, drain_after)


def test_replay_drains_to_balance_like_jax():
    js, ts = both_sources(offered_eps=2 * CAP_EPS, queue_events=96)
    assert_same_periods(js, ts, 6)
    assert ts.total.dropped > 0 and ts.pending > 0
    js.begin_drain()
    ts.begin_drain()
    n = 0
    while ts.pending:
        assert_same_periods(js, ts, 1)
        n += 1
    assert n > 0 and js.pending == 0
    t = ts.total
    assert t.offered == t.processed + t.dropped == 6 * 128


def test_replay_assembles_into_given_arrays():
    _, ts = both_sources(offered_eps=1.5 * CAP_EPS, queue_events=40)
    _, ref = both_sources(offered_eps=1.5 * CAP_EPS, queue_events=40)
    out = {"ts": np.empty(E, np.uint32), "size": np.empty(E, np.uint32),
           "five_tuple": np.empty((E, 5), np.uint32),
           "valid": np.empty(E, bool)}
    for _ in range(4):
        b, now, acct = ts.next_batch(out=out)
        w = ref.next_batch()
        assert all(b[k] is out[k] for k in out)
        for k in out:
            np.testing.assert_array_equal(b[k], w[0][k])


def test_replay_validation_fails_loud():
    _, (tev, tnows) = trace()
    with pytest.raises(ValueError, match="drop_policy"):
        TraceReplaySource(tev, tnows, batch_events=64, drop_policy="coldest")
    with pytest.raises(ValueError, match="batch_events"):
        TraceReplaySource(tev, tnows, batch_events=0)
    with pytest.raises(ValueError, match="offered_eps"):
        TraceReplaySource(tev, tnows, batch_events=64, offered_eps=-1.0)
    with pytest.raises(ValueError, match="stacked"):
        TraceReplaySource({k: v[0] for k, v in tev.items()}, tnows,
                          batch_events=64)
    with pytest.raises(ValueError, match="no valid events"):
        TraceReplaySource(dict(tev, valid=torch.zeros_like(tev["valid"])),
                          tnows, batch_events=64)


def test_latency_summary_known_samples():
    s = SERVE.latency_summary(list(range(1, 101)))
    assert s["p50"] == pytest.approx(50.5)
    assert s["p99"] == pytest.approx(99.01)
    assert s["p999"] == pytest.approx(99.901)
    s4 = SERVE.latency_summary([10.0, 20.0, 30.0, 40.0])
    assert s4["p50"] == pytest.approx(25.0)
    assert s4["p99"] == pytest.approx(39.7)
    assert s["count"] == 100 and s4["count"] == 4
    assert s4 == JSERVE.latency_summary([10.0, 20.0, 30.0, 40.0])


def test_latency_summary_empty_and_single():
    empty = SERVE.latency_summary([])
    assert empty["count"] == 0 and set(empty) == {"p50", "p99", "p999",
                                                  "count"}
    assert all(np.isnan(empty[k]) for k in ("p50", "p99", "p999"))
    one = SERVE.latency_summary([42.0])
    assert one["count"] == 1
    assert one["p50"] == one["p99"] == one["p999"] == 42.0


def systems(**kw):
    js = JSystem(dataclasses.replace(get_dfa_config(reduced=True),
                                     kernel_backend="ref", **kw),
                 make_mesh((1, 1), ("data", "model")))
    ts = DFASystem(dataclasses.replace(REDUCED, **kw), device="cpu")
    return js, ts


def assert_reports_match(jr, tr):
    for f in ("periods", "drained_periods", "budget_us", "offered",
              "processed", "dropped", "snapshots", "recoveries",
              "duplicate_recovery_skips", "journal_replayed"):
        assert getattr(jr, f) == getattr(tr, f), f
    assert [tuple(a) for a in jr.per_period] == \
        [tuple(a) for a in tr.per_period]
    assert jr.balanced == tr.balanced
    assert len(tr.latency_us) == len(jr.latency_us)
    assert tr.recovery_stall_us == []
    assert_state_equal(jr.last.state, tr.last.state)
    for k, v in jr.last.metrics.items():
        assert int(np.asarray(v)) == int(tr.last.metrics[k]), k


@pytest.mark.parametrize("case,kw,periods", [
    ("line rate", {}, 5),
    ("overrun, queue, drained", {"serve_offered_eps": 2 * 128 / 0.02,
                                 "serve_queue_events": 256}, 6),
    ("overrun, oldest", {"serve_offered_eps": 3 * 128 / 0.02,
                         "serve_queue_events": 128,
                         "drop_policy": "oldest"}, 4),
])
def test_serve_trace_matches_jax(case, kw, periods):
    js, ts = systems(**kw)
    (jev, jnows), (tev, tnows) = trace(T=3, E_=128, n_flows=40)
    jr = JSERVE.serve_trace(js, jev, jnows, periods=periods)
    tr = SERVE.serve_trace(ts, tev, tnows, periods=periods)
    assert_reports_match(jr, tr)
    assert tr.balanced
    if kw:
        assert tr.dropped > 0 and tr.drained_periods > 0
    assert set(tr.metrics) >= {"reports_sent", "seq_anomalies"}
    assert tr.metrics["reports_sent"].shape == (periods + tr.drained_periods,)
    assert set(tr.host_us) == {"replay", "stage", "dispatch", "wait"}
    assert tr.latency["count"] == periods + tr.drained_periods


def test_serving_loop_no_drain_matches_jax():
    kw = {"serve_offered_eps": 2 * 128 / 0.02, "serve_queue_events": 256}
    js, ts = systems(**kw)
    (jev, jnows), (tev, tnows) = trace(T=3, E_=128, n_flows=40)
    jsrc = JSERVE.build_source(js, jev, jnows)
    tsrc = SERVE.build_source(ts, tev, tnows)
    jr = JSERVE.ServingLoop(js, jsrc).run(4, drain=False)
    tr = SERVE.ServingLoop(ts, tsrc).run(4, drain=False)
    assert_reports_match(jr, tr)
    assert tr.drained_periods == 0 and tsrc.pending == jsrc.pending > 0
    assert tr.offered == tr.processed + tr.dropped + tsrc.pending


def test_zero_period_run_reports_explicit_empty():
    _, ts = systems()
    _, (tev, tnows) = trace()
    report = SERVE.serve_trace(ts, tev, tnows, periods=0, drain=False)
    assert report.periods == report.drained_periods == 0
    assert report.offered == report.processed == report.dropped == 0
    assert report.balanced and report.latency["count"] == 0
    assert report.sustained_eps == 0.0 and report.last is None
    with pytest.raises(ValueError, match="periods"):
        SERVE.serve_trace(ts, tev, tnows, periods=-1)


def test_serving_loop_refusals():
    _, (tev, tnows) = trace()
    src = TraceReplaySource(tev, tnows, batch_events=63)
    two_shards = types.SimpleNamespace(n_shards=2, cfg=REDUCED,
                                       device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide across"):
        SERVE.ServingLoop(two_shards, src)
    # in-loop recovery: the loop builds with a heartbeat, a chaos hook and
    # survivor devices on a 2-pod rendezvous system; a recovery with no
    # snapshot directory raises the reference's error
    ts = DFASystem(dataclasses.replace(
        REDUCED, flow_home="rendezvous", pods=2, ports_per_pod=2,
        reporter_slots=64, port_report_capacity=16), device="cpu",
        n_shards=4)
    src4 = TraceReplaySource(tev, tnows, batch_events=4 * 32)
    hb = Heartbeat(os.devnull, expected_peers={0: 0, 1: 1})
    for kw in ({"heartbeat": hb}, {"chaos": lambda t: []},
               {"recovery_devices": ["cpu"]}):
        assert SERVE.ServingLoop(ts, src4, **kw).system is ts
    loop = SERVE.ServingLoop(ts, src4, snapshot_dir=None,
                             chaos=lambda t: [1], recovery_devices="cpu")
    with pytest.raises(RuntimeError, match="needs snapshots"):
        loop.run(2)


def test_cpu_ring_stages_plain_tensors():
    ring = SERVE.HostIngestRing("cpu", 4)
    assert ring.host_slot() is None
    batch = {"ts": np.arange(4, dtype=np.uint32),
             "size": np.full(4, 0xFFFFFFFF, np.uint32),
             "five_tuple": np.ones((4, 5), np.uint32),
             "valid": np.array([1, 1, 0, 0], bool)}
    ev, now = ring.stage(batch, np.uint32(20_000))
    assert ev["ts"].dtype == torch.int32 and ev["valid"].dtype == torch.bool
    assert int(ev["size"][0]) == -1 and int(now) == 20_000
    assert ring.staged == 1
