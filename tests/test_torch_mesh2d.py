"""The port's 2-D (pod, shard) mesh and its translator functions against
the JAX reference.

``DFASystem(cfg, device="cpu", n_shards=n)`` with ``flow_home`` "hash" or
"rendezvous" emulates the reference's (``cfg.pods``, n // pods) mesh in
one process: per-port reporter tables, hash-home / HRW flow ids, the
two-stage exchange (padded or ragged) and the home's canonical order.

* the port's scenario library equals ``repro.data.scenarios``;
* REDUCED_MULTIPOD and REDUCED_MULTIPOD_V2 reproduce the two multipod
  goldens through the golden test's own fingerprint, ``ring_checksum``
  included;
* on (2, 2), hash (padded and ragged) and rendezvous over a
  non-contiguous node roster match the reference's jitted ``dfa_step``
  period by period through both port drivers (metrics and state bit for
  bit, features row-scaled against the op-by-op oracle), as does the
  264-port V2 mesh at one grid point;
* ragged == padded, and the port alone is pod-count invariant over the
  (1,2) / (2,2) / (4,1) grid for every scenario, both drivers;
* the translator's home functions equal the reference's on the same
  inputs (ids >= 2^31 and beyond the keyspace, padding, ties, HRW over
  non-contiguous rosters, ``_mix32`` over the whole u32 range);
* the topology refusals raise the reference's exception types.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import pod_mesh_or_skip
from repro.configs.dfa import REDUCED_MULTIPOD as JMULTIPOD
from repro.configs.dfa import REDUCED_MULTIPOD_V2 as JMULTIPOD_V2
from repro.core import translator as JT
from repro.core import wire as JWIRE
from repro.core.pipeline import DFASystem as JSystem
from repro.data import scenarios as JSC
from repro_torch import u32 as U
from repro_torch.configs import (REDUCED, REDUCED_MULTIPOD,
                                 REDUCED_MULTIPOD_V2)
from repro_torch.convert import state_to_numpy
from repro_torch.core import translator as TT
from repro_torch.core import wire as WIRE
from repro_torch.core.pipeline import DFASystem
from repro_torch.data import scenarios as SC
from test_multipod_equiv import _canon_periods, _merged_state
from test_run_periods_golden import (EVENTS_PER_SHARD, GOLDEN_DIR,
                                     _assert_matches, _fingerprint)
from test_torch_mesh import assert_stream_matches, reference_periods

T = 3
TOTAL_PORTS = 4
EVENTS_PER_PORT = 48
G = 512                  # global ring keyspace, fixed across meshes
GRID = ((1, 2), (2, 2), (4, 1))
NODES = (0, 3, 5, 9)     # a non-contiguous rendezvous roster


def torch_events(ev, nows):
    return ({k: (torch.from_numpy(v) if k == "valid" else U.from_numpy(v))
             for k, v in ev.items()},
            torch.from_numpy(np.asarray(nows, np.int64)))


def build_trace(name, ports, events_per_port, periods, seed=0):
    return torch_events(*SC.build(name, ports, events_per_port, periods,
                                  seed=seed))


@pytest.mark.parametrize("name", sorted(JSC.SCENARIOS))
def test_scenarios_match_reference(name):
    assert sorted(SC.SCENARIOS) == sorted(JSC.SCENARIOS)
    want_ev, want_nows = JSC.build(name, 6, 24, 3, seed=5)
    got_ev, got_nows = SC.build(name, 6, 24, 3, seed=5)
    assert sorted(got_ev) == sorted(want_ev)
    for k in want_ev:
        assert got_ev[k].dtype == want_ev[k].dtype, k
        np.testing.assert_array_equal(got_ev[k], want_ev[k], err_msg=k)
    assert got_nows.dtype == want_nows.dtype
    np.testing.assert_array_equal(got_nows, want_nows)


# -- the multipod goldens -----------------------------------------------------

@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_reproduces_multipod_goldens(wire):
    if wire == "v1":
        cfg, name = REDUCED_MULTIPOD, "run_periods_multipod_t4"
    else:
        cfg = dataclasses.replace(REDUCED_MULTIPOD_V2,
                                  port_report_capacity=32)
        name = "run_periods_multipod_v2_t4"
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        want = json.load(f)
    ts = DFASystem(cfg, device="cpu", n_shards=4)
    assert ts.wire.name == wire and ts.total_ports == 4
    ev, nows = build_trace("cross_pod_mix", ts.total_ports,
                           EVENTS_PER_SHARD // ts.total_ports, want["T"],
                           seed=3)
    out = ts.run_periods(ts.init_state(), ev, nows)
    state = state_to_numpy(out.state)
    extra = {"mesh": [2, 2], "total_ports": ts.total_ports,
             "flow_home": "hash"}
    if wire == "v2":
        extra.update(wire_format="v2", ring_checksum=int(
            np.bitwise_xor.reduce(state.collector.memory.reshape(-1))))
    got = _fingerprint(state, out.enriched.numpy(), out.flow_ids.numpy(),
                       out.mask.numpy(),
                       {k: v.numpy() for k, v in out.metrics.items()},
                       extra=extra)
    _assert_matches(got, want)
    for k in ("mesh", "total_ports", "flow_home", "wire_format"):
        assert got.get(k) == want.get(k), k


# -- the 2-D mesh against the reference ---------------------------------------

_cases = {}


def case(key):
    """(reference periods, port system, port events, nows) on (2, 2),
    built once per key: "hash", "ragged", "rendezvous" (REDUCED_MULTIPOD,
    cross_pod_mix) or "v2-264" (264 ports under V2, wide_port_sweep)."""
    if key not in _cases:
        if key == "v2-264":
            kw = dict(pods=2, ports_per_pod=132, flows_per_shard=8192 // 4,
                      port_report_capacity=4)
            jcfg = dataclasses.replace(JMULTIPOD_V2, kernel_backend="ref",
                                       **kw)
            tcfg = dataclasses.replace(REDUCED_MULTIPOD_V2, **kw)
            name, ports, epp, periods = "wide_port_sweep", 264, 2, 2
        else:
            kw = {"hash": {}, "ragged": {"crosspod_exchange": "ragged"},
                  "rendezvous": {"flow_home": "rendezvous",
                                 "home_nodes": NODES}}[key]
            jcfg = dataclasses.replace(JMULTIPOD, kernel_backend="ref", **kw)
            tcfg = dataclasses.replace(REDUCED_MULTIPOD, **kw)
            name, ports, epp, periods = "cross_pod_mix", 4, 32, 4
        js = JSystem(jcfg, pod_mesh_or_skip(2, 2))
        ev, nows = JSC.build(name, ports, epp, periods, seed=3)
        fps = jcfg.flows_per_shard
        nodes = NODES if key == "rendezvous" else range(4)
        ref = reference_periods(js, {k: jnp.asarray(v) for k, v in
                                     ev.items()}, jnp.asarray(nows),
                                [d * fps for d in nodes])
        ts = DFASystem(tcfg, device="cpu", n_shards=4)
        _cases[key] = (ref, ts) + torch_events(ev, nows)
    return _cases[key]


@pytest.mark.parametrize("driver", ["sequential", "overlapped"])
@pytest.mark.parametrize("key", ["hash", "ragged", "rendezvous", "v2-264"])
def test_mesh2d_matches_jax(key, driver):
    ref, ts, tev, tnows = case(key)
    out = ts.stream(ts.init_state(), tev, tnows,
                    overlapped=driver == "overlapped")
    assert_stream_matches(ref, out, f"{key} {driver}: ")
    m = {k: v.numpy() for k, v in out.metrics.items()}
    assert m["reports_recv"].sum() > 0 and m["bucket_drops"].sum() == 0
    assert ("crosspod_sent" in m) == (key == "ragged")
    if key == "v2-264":
        # ports past V1's 8-bit reporter id space reported
        assert (state_to_numpy(out.state).reporter.seq[256:] > 0).any()
    if key == "rendezvous":
        homes = out.flow_ids[out.mask] // ts.cfg.flows_per_shard
        assert set(homes.tolist()) == set(NODES)


def test_describe_matches_reference_on_2d():
    js = JSystem(dataclasses.replace(JMULTIPOD, crosspod_exchange="ragged"),
                 pod_mesh_or_skip(2, 2))
    ts = DFASystem(dataclasses.replace(REDUCED_MULTIPOD,
                                       crosspod_exchange="ragged"),
                   device="cpu", n_shards=4)
    want, got = js.describe(), ts.describe()
    for k in ("n_shards", "flow_home", "pods", "shards_per_pod",
              "total_ports", "ports_per_device", "reporter_slots",
              "port_report_capacity", "crosspod_exchange",
              "crosspod_capacity", "stage2_capacity", "home_nodes"):
        assert got[k] == want[k], k
    assert got["pods"] == 2 and got["crosspod_capacity"] == 64


# -- the port alone: ragged == padded, pod-count invariance -------------------

_runs = {}


def grid_cfg(pods, shards, **kw):
    kw = {"flow_home": "hash", **kw}
    return dataclasses.replace(
        REDUCED, pods=pods, ports_per_pod=TOTAL_PORTS // pods,
        reporter_slots=64, flows_per_shard=G // (pods * shards),
        port_report_capacity=16, **kw)


def grid_run(pods, shards, overlapped, scenario, **kw):
    """(merged state, flow-sorted periods, metrics) of one port run."""
    ts = DFASystem(grid_cfg(pods, shards, **kw), device="cpu",
                   n_shards=pods * shards)
    if scenario not in _runs:
        _runs[scenario] = build_trace(scenario, TOTAL_PORTS,
                                      EVENTS_PER_PORT, T)
    ev, nows = _runs[scenario]
    out = ts.stream(ts.init_state(), ev, nows, overlapped=overlapped)
    return (ts, _merged_state(ts, state_to_numpy(out.state)),
            _canon_periods(out.enriched, out.flow_ids, out.mask),
            {k: v.numpy() for k, v in out.metrics.items()})


def assert_same(a, b, ctx, metrics=None):
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k],
                                      err_msg=f"{ctx}: state {k}")
    for t, (x, y) in enumerate(zip(a[1], b[1])):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k],
                                          err_msg=f"{ctx}: period {t} {k}")
    for k in metrics or a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k],
                                      err_msg=f"{ctx}: metric {k}")


@pytest.mark.parametrize("flow_home", ["hash", "rendezvous"])
def test_ragged_equals_padded(flow_home):
    """Auto capacity: the ragged exchange equals the padded one bit for
    bit and adds only its two volume metrics; a tight capacity counts
    what it cannot ship as bucket drops."""
    for overlapped in (False, True):
        _, *padded = grid_run(2, 2, overlapped, "cross_pod_mix",
                              flow_home=flow_home)
        _, *ragged = grid_run(2, 2, overlapped, "cross_pod_mix",
                              flow_home=flow_home,
                              crosspod_exchange="ragged")
        assert sorted(ragged[2]) == sorted(
            list(padded[2]) + ["crosspod_messages", "crosspod_sent"])
        assert_same(padded, ragged, f"{flow_home} ovl={overlapped}",
                    metrics=padded[2])
        x = ragged[2]
        assert x["crosspod_sent"].sum() > 0
        assert (x["crosspod_messages"] <= x["crosspod_sent"]).all()
    _, *tight = grid_run(2, 2, False, "cross_pod_mix", flow_home=flow_home,
                         crosspod_exchange="ragged", crosspod_capacity=2)
    m = tight[2]
    assert m["bucket_drops"].sum() > 0
    np.testing.assert_array_equal(
        m["reports_sent"], m["reports_recv"] + m["bucket_drops"]
        + m["misroutes"])


@pytest.mark.parametrize("scenario", sorted(SC.SCENARIOS))
def test_pod_count_invariance(scenario):
    """(1,2) == (2,2) == (4,1), both drivers: merged state, flow-sorted
    period outputs and every metric, bit for bit."""
    for overlapped in (False, True):
        ts, *ref = grid_run(*GRID[0], overlapped, scenario)
        assert ref[2]["reports_recv"].sum() > 0
        assert ref[2]["bucket_drops"].sum() == 0
        assert (ref[0]["rep.seq"] <= ts.wire.seq_mask).all()
        for pods, shards in GRID[1:]:
            _, *got = grid_run(pods, shards, overlapped, scenario)
            assert_same(ref, got, f"{scenario} ovl={overlapped} "
                                  f"({pods},{shards})")


# -- translator functions against the reference -------------------------------

def u32s(rng, n):
    edge = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint64)
    return np.concatenate([edge, rng.integers(0, 1 << 32, n,
                                              dtype=np.uint64)]
                          ).astype(np.uint32)


def tt(a):
    """numpy u32 -> the port's int32 bit patterns."""
    return U.from_numpy(a)


def assert_u32(got, want):
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.int64) & 0xFFFFFFFF,
        np.asarray(want).astype(np.int64) & 0xFFFFFFFF)


def test_u32_mul_and_mix32_over_the_whole_range():
    rng = np.random.default_rng(0)
    a, b = u32s(rng, 200_000), u32s(rng, 200_000)[::-1].copy()
    assert_u32(U.mul(tt(a), tt(b)),
               (a.astype(np.uint64) * b.astype(np.uint64)) & 0xFFFFFFFF)
    assert_u32(U.mul(tt(a), 0x846CA68B),
               (a.astype(np.uint64) * 0x846CA68B) & 0xFFFFFFFF)
    assert_u32(TT._mix32(tt(a)), JT._mix32(jnp.asarray(a)))
    # the whole range in a strided sweep
    x = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
    assert_u32(TT._mix32(torch.from_numpy(x.astype(np.int64))),
               JT._mix32(jnp.asarray(x)))


@pytest.mark.parametrize("S,n", [(2, 4), (1, 4), (4, 4), (3, 6)])
def test_home_coords_and_ids_match_reference(S, n):
    """Ids >= 2^31 go negative as int32 (pod out of range, shard floor-
    mod into range), ids beyond the keyspace land past the last device."""
    rng = np.random.default_rng(S * 10 + n)
    fps = 128
    fid = np.concatenate([u32s(rng, 300),
                          np.arange(0, n * fps + 300, 37, dtype=np.uint32)])
    want = JT.home_coords(jnp.asarray(fid), fps, S, n)
    for x in (tt(fid), torch.from_numpy(fid.astype(np.int64))):
        got = TT.home_coords(x, fps, S, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(np.int64))
    pod = np.asarray(want[0])
    assert (pod < 0).any() and (pod >= n // S).any()
    keys = rng.integers(0, 1 << 32, (500, 5), dtype=np.uint64).astype(
        np.uint32)
    for total in (n * fps, 1000):
        assert_u32(TT.home_flow_ids(tt(keys), total),
                   JT.home_flow_ids(jnp.asarray(keys), total))


@pytest.mark.parametrize("nodes", [(0, 1, 2, 3), NODES,
                                   (1, 1000, 1 << 20, (1 << 31) + 7)])
@pytest.mark.parametrize("fps", [128, 100])
def test_rendezvous_matches_reference(nodes, fps):
    rng = np.random.default_rng(len(nodes) + fps)
    nid = np.asarray(nodes, np.uint32)
    kh = u32s(rng, 2000)
    want = np.asarray(JT.rendezvous_position(jnp.asarray(kh),
                                             jnp.asarray(nid)))
    got = TT.rendezvous_position(tt(kh), tt(nid)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert len(set(got.tolist())) == len(nodes)
    keys = rng.integers(0, 1 << 32, (800, 5), dtype=np.uint64).astype(
        np.uint32)
    fids_w = JT.rendezvous_flow_ids(jnp.asarray(keys), jnp.asarray(nid), fps)
    fids_g = TT.rendezvous_flow_ids(tt(keys), tt(nid), fps)
    assert_u32(fids_g, fids_w)
    # node_position of the flows' nodes and of ids off the roster
    q = np.concatenate([(np.asarray(fids_w).astype(np.uint64) // fps
                         ).astype(np.uint32), u32s(rng, 50)])
    np.testing.assert_array_equal(
        TT.node_position(tt(q), tt(nid)).numpy(),
        np.asarray(JT.node_position(jnp.asarray(q), jnp.asarray(nid))
                   ).astype(np.int64))


def report_batch(rng, R, wire, n_flows, hostile=True):
    """Reports with repeated flows, tied (flow, meta) keys, ids >= 2^31
    and masked rows holding garbage."""
    W = wire.report_words
    rep = rng.integers(0, 1 << 32, (R, W), dtype=np.uint64).astype(np.uint32)
    rep[:, 0] = rng.integers(0, n_flows, R).astype(np.uint32)
    if hostile:
        rep[: R // 8, 0] = u32s(rng, R // 8)[: R // 8] | 0x80000000
    rid = rng.integers(0, 3, R).astype(np.uint32)
    seq = rng.integers(0, 4, R).astype(np.uint32)
    rep[:, wire.report_meta_word] = (
        (rid << wire.report_reporter.shift)
        | (seq << wire.report_seq.shift)).astype(np.uint32)
    mask = rng.random(R) < 0.8
    return rep, mask


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_canonical_order_matches_reference(wire):
    rng = np.random.default_rng(7)
    rep, mask = report_batch(rng, 300, WIRE.get(wire), 20)
    jr, jm = JT.canonical_order(jnp.asarray(rep), jnp.asarray(mask),
                                wire=JWIRE.get(wire))
    tr, tm = TT.canonical_order(tt(rep), torch.from_numpy(mask),
                                wire=WIRE.get(wire))
    np.testing.assert_array_equal(tr.numpy().view(np.uint32),
                                  np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # valid rows first, ids >= 2^31 after the small ones
    k = int(mask.sum())
    assert tm[:k].all() and not tm[k:].any()
    f = tr[:k, 0].numpy().view(np.uint32)
    assert (np.diff(f.astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("capacity", [0, 3])
@pytest.mark.parametrize("own_pod", [0, 1])
def test_crosspod_compact_matches_reference(own_pod, capacity):
    rng = np.random.default_rng(own_pod * 3 + capacity)
    wf, jwf = WIRE.V1, JWIRE.V1
    rep, mask = report_batch(rng, 256, wf, 512)
    cap = capacity or 256
    args = (own_pod, 2, cap)
    want = JT.crosspod_compact(
        jnp.asarray(rep), jnp.asarray(mask), *args,
        lambda f: JT.home_coords(f, 128, 2, 4)[0], wire=jwf)
    got = TT.crosspod_compact(
        tt(rep), torch.from_numpy(mask), *args,
        lambda f: TT.home_coords(f, 128, 2, 4)[0], wire=wf)
    names = ("local_rows", "local_mask", "buckets", "bucket_mask",
             "misroutes", "n_messages")
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        w = np.asarray(w)
        if g.dtype == np.int32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert int(got[4]) > 0              # the hostile ids misroute


# -- topology refusals, each as the reference raises it -----------------------

REFUSALS = {
    # id: (port cfg changes, n_shards, reference cfg changes, mesh, match)
    "pods-do-not-divide": (
        dict(pods=3), 4, dict(pods=4), (2, 2), "pod axis"),
    "ports-not-a-device-multiple": (
        dict(ports_per_pod=3), 4, dict(ports_per_pod=3), (2, 2),
        "multiple of the device count"),
    "v1-over-256-ports": (
        dict(pods=1, ports_per_pod=512, port_report_capacity=1), 1,
        dict(pods=1, ports_per_pod=512, port_report_capacity=1), (1, 1),
        "8-bit reporter id"),
    "capacity-over-stage2": (
        dict(crosspod_exchange="ragged", crosspod_capacity=10 ** 6), 4,
        dict(crosspod_exchange="ragged", crosspod_capacity=10 ** 6), (2, 2),
        "exceeds the worst-case"),
    "capacity-on-padded": (
        dict(crosspod_capacity=8), 4, dict(crosspod_capacity=8), (2, 2),
        "only applies to"),
    "negative-capacity": (
        dict(crosspod_capacity=-1), 4, dict(crosspod_capacity=-1), (2, 2),
        "must be >= 0"),
    "unknown-exchange": (
        dict(crosspod_exchange="sparse"), 4, dict(crosspod_exchange="sparse"),
        (2, 2), "crosspod_exchange must be"),
    "unknown-home": (
        dict(flow_home="random"), 4, dict(flow_home="random"), (2, 2),
        "flow_home must be"),
    "roster-length": (
        dict(flow_home="rendezvous", home_nodes=(0, 1, 2)), 4,
        dict(flow_home="rendezvous", home_nodes=(0, 1, 2)), (2, 2),
        "entries for a"),
    "roster-order": (
        dict(flow_home="rendezvous", home_nodes=(0, 5, 3, 9)), 4,
        dict(flow_home="rendezvous", home_nodes=(0, 5, 3, 9)), (2, 2),
        "strictly increasing"),
    "ingest-multipod": (
        dict(flow_home="ingest", ports_per_pod=0, reporter_slots=0,
             port_report_capacity=0), 4,
        dict(flow_home="ingest", ports_per_pod=0, reporter_slots=0,
             port_report_capacity=0), (2, 2), "needs flow_home='hash'"),
    "ingest-ports": (
        dict(flow_home="ingest", pods=1, reporter_slots=0), 4,
        dict(flow_home="ingest", pods=1, reporter_slots=0), (1, 4),
        "exactly one port per"),
    "ingest-slots": (
        dict(flow_home="ingest", pods=1, ports_per_pod=0, reporter_slots=64),
        4, dict(flow_home="ingest", pods=1, ports_per_pod=0,
                reporter_slots=64), (1, 4),
        "reporter_slots must equal"),
    "ingest-ragged": (
        dict(flow_home="ingest", pods=1, ports_per_pod=0, reporter_slots=0,
             crosspod_exchange="ragged"), 4,
        dict(flow_home="ingest", pods=1, ports_per_pod=0, reporter_slots=0,
             crosspod_exchange="ragged"), (1, 4), "no pod stage"),
    "ingest-capacity": (
        dict(flow_home="ingest", pods=1, ports_per_pod=0, reporter_slots=0,
             crosspod_capacity=4), 4,
        dict(flow_home="ingest", pods=1, ports_per_pod=0, reporter_slots=0,
             crosspod_capacity=4), (1, 4), "meaningless"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_topology_refusals_match_reference(name):
    tkw, n, jkw, mesh, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        JSystem(dataclasses.replace(JMULTIPOD, **jkw),
                pod_mesh_or_skip(*mesh))
    with pytest.raises(ValueError, match=match):
        DFASystem(dataclasses.replace(REDUCED_MULTIPOD, **tkw),
                  device="cpu", n_shards=n)


def test_v2_lifts_the_port_cap_and_uneven_events_refused():
    cfg = dataclasses.replace(REDUCED, flow_home="hash", wire_format="v2",
                              ports_per_pod=512, reporter_slots=8,
                              port_report_capacity=1)
    assert DFASystem(cfg, device="cpu").total_ports == 512
    ts = DFASystem(dataclasses.replace(
        REDUCED, flow_home="hash", ports_per_pod=4, reporter_slots=64,
        flows_per_shard=256, port_report_capacity=8), device="cpu")
    assert ts.ports_per_device == 4
    ev, nows = build_trace("port_local", 4, 32, 1)
    with pytest.raises(ValueError, match="divide across"):
        ts.dfa_step(ts.init_state(), {k: v[0][:-2] for k, v in ev.items()},
                    nows[0])
