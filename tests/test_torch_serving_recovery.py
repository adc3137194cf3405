"""The port's serving loop on a mesh, and its live in-loop recovery, against
the JAX reference.

* The loop on a mesh: a 4-shard REDUCED ``ServingLoop`` — the (2,2)
  rendezvous mesh at line rate and over rate into a queue, and the 1-D
  mesh (``flow_home="ingest"``, n = 4) — against the reference's loop on
  its (2,2) mesh: the end state, ``offered`` / ``processed`` / ``dropped``
  and every period's accounting, bit for bit.
* Live recovery (the cases of tests/test_serving_recovery.py): pod 0
  dies after period ``kill_at``; the loop restores the newest snapshot,
  rebuilds on the (1,2) survivor mesh, re-homes, re-feeds the journal and
  keeps serving. Its final state, ``recoveries``, ``journal_replayed`` and
  ``duplicate_recovery_skips`` equal the reference loop's, and the state
  equals the offline path (``elastic.recover_from_snapshot`` plus the same
  batches through the survivor system).
* A second declaration of a removed pod is a counted no-op; a heartbeat
  trip recovers and then disarms; no snapshots and a journal that does not
  reach the snapshot are refused with the reference's errors.
* The journal keeps batch recipes: each one re-assembles the batch that
  was staged, exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import pod_mesh_or_skip
from repro.compat import make_mesh
from repro.configs.dfa import REDUCED as JREDUCED
from repro.core.pipeline import DFASystem as JSystem
from repro.data import scenarios as JSC
from repro.launch import serving as JSERVE
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import REDUCED
from repro_torch.convert import state_to_numpy
from repro_torch.core.pipeline import DFASystem
from repro_torch.distributed.monitor import Heartbeat
from repro_torch.launch import elastic as EL
from repro_torch.launch import serving as SERVE
from test_torch_mesh import assert_state_equal

TOTAL_PORTS = 4
EVENTS_PER_PORT = 48
T = 6
SNAP_EVERY = 2
FPS = 512
REPORTER_SLOTS = 64
PORT_CAPACITY = 16
CAP_EPS = 4 * REDUCED.event_block / 0.02     # a 4-shard batch per period

_refs = {}
_trace = {}


def knobs(pods, nodes=(), snap_every=SNAP_EVERY, home="rendezvous", **kw):
    if home == "ingest":
        return dict(snapshot_every_periods=snap_every, **kw)
    return {**dict(flow_home=home, pods=pods,
                   ports_per_pod=TOTAL_PORTS // pods,
                   reporter_slots=REPORTER_SLOTS, flows_per_shard=FPS,
                   port_report_capacity=PORT_CAPACITY, home_nodes=nodes,
                   snapshot_every_periods=snap_every), **kw}


def port(pods=2, nodes=(), **kw):
    return DFASystem(dataclasses.replace(REDUCED, **knobs(pods, nodes, **kw)),
                     device="cpu", n_shards=2 * pods)


def ref(pods=2, nodes=(), **kw):
    key = (pods, nodes, tuple(sorted(kw.items())))
    if key not in _refs:
        cfg = dataclasses.replace(JREDUCED, kernel_backend="ref",
                                  **knobs(pods, nodes, **kw))
        mesh = (make_mesh((2, 2), ("data", "model"))
                if kw.get("home") == "ingest"
                else pod_mesh_or_skip(pods, 2))
        _refs[key] = JSystem(cfg, mesh)
    return _refs[key]


def trace():
    if "t" not in _trace:
        _trace["t"] = JSC.build("cross_pod_mix", TOTAL_PORTS,
                                EVENTS_PER_PORT, T)
    return _trace["t"]


def port_loop(system, **kw):
    return SERVE.ServingLoop(system, SERVE.build_source(system, *trace()),
                             **kw)


def ref_loop(system, **kw):
    return JSERVE.ServingLoop(system, JSERVE.build_source(system, *trace()),
                              **kw)


def survivor_devices(js):
    return js.mesh.devices.reshape(-1)[:2].tolist()


def np_state(state):
    return jax.tree.map(np.asarray, state)


def assert_same_accounting(jr, tr):
    assert (tr.offered, tr.processed, tr.dropped) == (
        jr.offered, jr.processed, jr.dropped)
    assert [tuple(a) for a in tr.per_period] == [tuple(a)
                                                 for a in jr.per_period]
    assert tr.drained_periods == jr.drained_periods
    assert len(tr.latency_us) == len(jr.latency_us)


# -- the serving loop on a mesh (ROADMAP item 10a) ----------------------------

MESH_CASES = {
    "rendezvous (2,2), line rate": {},
    "rendezvous (2,2), over rate into a queue": {
        "serve_offered_eps": 2.5 * CAP_EPS, "serve_queue_events": 256,
        "drop_policy": "oldest"},
    "ingest, 4 shards, line rate": {"home": "ingest"},
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_serving_loop_matches_reference(case):
    kw = MESH_CASES[case]
    js, ts = ref(**kw), port(**kw)
    assert ts.n_shards == 4
    jr = ref_loop(js).run(T)
    tr = port_loop(ts).run(T)
    assert_same_accounting(jr, tr)
    assert tr.balanced and tr.processed > 0
    if "serve_queue_events" in kw:
        assert tr.dropped > 0 and tr.drained_periods > 0
    assert int(tr.metrics["reports_recv"].sum()) > 0
    assert_state_equal(np_state(jr.last.state), tr.last.state)
    assert tr.recoveries == tr.journal_replayed == 0


# -- live recovery --------------------------------------------------------------

def offline(full, dead_pod, kill_at, snap_dir, snap_every=SNAP_EVERY):
    """What live recovery must give, the offline way: run the full mesh to
    the last snapshot before ``kill_at``, save, ``recover_from_snapshot``,
    then the remaining batches (from an identically built source) through
    the survivor system."""
    src = SERVE.build_source(full, *trace())
    batches = [src.next_batch()[:2] for _ in range(T)]
    snap_at = (kill_at // snap_every) * snap_every
    state = full.init_state()
    for b, now in batches[:snap_at]:
        state = full.dfa_step(state, *SERVE.host_tensors(b, now)).state
    CKPT.save(state, snap_dir, step=snap_at)
    new, state, period = EL.recover_from_snapshot(full, snap_dir, dead_pod,
                                                  devices="cpu")
    assert period == snap_at
    for b, now in batches[snap_at:]:
        state = new.dfa_step(state, *SERVE.host_tensors(b, now)).state
    return new, state


@pytest.mark.parametrize("kill_at,replay", [(SNAP_EVERY * 2, 0),
                                            (SNAP_EVERY * 2 + 1, 1)],
                         ids=["at-snapshot", "mid-window"])
def test_live_recovery_matches_reference(kill_at, replay, tmp_path):
    def chaos(t):
        return [0] if t == kill_at else []

    js = ref()
    jr = ref_loop(js, snapshot_dir=str(tmp_path / "ref"), chaos=chaos,
                  recovery_devices=survivor_devices(js)).run(T)
    loop = port_loop(port(), snapshot_dir=str(tmp_path / "live"),
                     chaos=chaos)
    tr = loop.run(T)
    assert (tr.recoveries, tr.journal_replayed,
            tr.duplicate_recovery_skips) == (
        jr.recoveries, jr.journal_replayed,
        jr.duplicate_recovery_skips) == (1, replay, 0)
    assert len(tr.recovery_stall_us) == 1 and tr.recovery_stall_us[0] > 0
    assert set(tr.recovery_us[0]) == {"restore", "rehome", "replay"}
    assert len(tr.latency_us) == T and tr.balanced
    assert_same_accounting(jr, tr)
    assert loop.system.home_nodes == (2, 3) and loop.system.n_shards == 2
    assert loop._live_pods == [1] and loop._removed_pods == {0}
    assert_state_equal(np_state(jr.last.state), tr.last.state)
    _, want = offline(port(), 0, kill_at, str(tmp_path / "off"))
    assert_state_equal(np_state(jr.last.state), want)


def test_duplicate_death_declaration_is_counted_noop(tmp_path):
    kill_at = SNAP_EVERY * 2
    loop = port_loop(port(), snapshot_dir=str(tmp_path / "live"),
                     chaos=lambda t: [0] if t in (kill_at, kill_at + 1)
                     else [])
    report = loop.run(T)
    assert report.recoveries == 1 and report.duplicate_recovery_skips == 1
    assert len(report.recovery_stall_us) == 1
    _, want = offline(port(), 0, kill_at, str(tmp_path / "off"))
    assert_state_equal(state_to_numpy(want), report.last.state)


def test_heartbeat_trip_recovers_then_disarms(tmp_path):
    hb_dir = str(tmp_path / "hb")
    hb = Heartbeat(hb_dir, process_index=0, stale_after_s=60.0,
                   expected_peers={0: 0, 1: 0, 2: 1, 3: 1})
    hb.beat(step=0)
    Heartbeat(hb_dir, process_index=1, pod=0).beat(step=0)
    # procs 2, 3 (pod 1) never beat: a whole-pod trip on the first scan
    loop = port_loop(port(snap_every=1), snapshot_dir=str(tmp_path / "snap"),
                     heartbeat=hb, recovery_devices=["cpu"])
    report = loop.run(T)
    assert report.recoveries == 1 and report.duplicate_recovery_skips == 0
    assert hb.retired == {2, 3} and EL.whole_dead_pods(hb) == []
    assert loop.system.home_nodes == (0, 1) and report.balanced
    _, want = offline(port(snap_every=1), 1, 1, str(tmp_path / "off"),
                      snap_every=1)
    assert_state_equal(state_to_numpy(want), report.last.state)


def test_recovery_without_snapshots_refused():
    loop = port_loop(port(), snapshot_dir=None,
                     chaos=lambda t: [0] if t == 1 else [])
    with pytest.raises(RuntimeError, match="needs snapshots"):
        loop.run(T)


def test_journal_window_too_shallow_refused(tmp_path):
    """Seeded with a period-0 snapshot and snapshotting off, the journal
    (depth 2) cannot bridge back to period 0 from period 3."""
    full = port(snap_every=0)
    snap = str(tmp_path / "snap")
    CKPT.save(full.init_state(), snap, step=0, keep=1)
    loop = port_loop(full, snapshot_dir=snap,
                     chaos=lambda t: [0] if t == 3 else [])
    with pytest.raises(RuntimeError, match="journal window"):
        loop.run(T)


@pytest.mark.parametrize("rate", ["line rate", "over rate, newest, drained"])
def test_journal_recipes_reassemble_the_staged_batches(rate):
    """Every journal entry's recipe re-assembles, into fresh arrays, the
    batch the ring staged for that period (a queue that splits batches
    into several runs and a trace that wraps included); the journal holds
    the last snapshot window's periods, 1-indexed."""
    kw = {} if rate == "line rate" else {
        "serve_offered_eps": 2.5 * CAP_EPS, "serve_queue_events": 300,
        "drop_policy": "newest"}
    loop = port_loop(port(**kw), snapshot_dir=None)
    assert loop._journal.maxlen == SNAP_EVERY + 1
    staged = []
    stage = loop.ring.stage

    def spy(batch, now):
        staged.append(({k: v.copy() for k, v in batch.items()}, int(now)))
        return stage(batch, now)

    loop.ring.stage = spy
    report = loop.run(T)
    n = T + report.drained_periods
    assert len(staged) == n
    tags = [idx for idx, _, _ in loop._journal]
    assert tags == list(range(n - SNAP_EVERY, n + 1))
    for idx, recipe, now in loop._journal:
        batch, want_now = staged[idx - 1]
        got = loop.source.rebuild(recipe)
        assert int(now) == want_now
        for k in batch:
            np.testing.assert_array_equal(got[k], batch[k], err_msg=k)
            assert got[k].dtype == batch[k].dtype
    runs = max(len(r.runs) for _, r, _ in loop._journal)
    assert runs >= (1 if rate == "line rate" else 2)


def test_pending_batch_restaged_on_the_survivors_device(tmp_path):
    """When the survivor runs on another device than the ring stages to,
    the pending batch is assembled again from its recipe and staged on a
    new ring there; the run still ends in the offline state. (The ring is
    marked as staging to ``cpu:0``, which is not the survivor's ``cpu``.)"""
    kill_at = SNAP_EVERY * 2 + 1
    loop = port_loop(port(), snapshot_dir=str(tmp_path / "live"),
                     chaos=lambda t: [0] if t == kill_at else [])
    loop.ring.device = torch.device("cpu", 0)
    old_ring = loop.ring
    report = loop.run(T)
    assert loop.ring is not old_ring and loop.ring.device == torch.device("cpu")
    assert report.recoveries == 1 and report.balanced
    _, want = offline(port(), 0, kill_at, str(tmp_path / "off"))
    assert_state_equal(state_to_numpy(want), report.last.state)
