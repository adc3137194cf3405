"""The port's fault-tolerance monitor (``repro_torch.distributed.monitor``)
against the cases of tests/test_monitor.py (the pod-axis pipeline guard
is held in tests/test_torch_dist.py), plus
one roster read across the two packages: beat files written by either
package's ``Heartbeat`` give the same dead peers by pod in both."""
import dataclasses
import inspect
import time

import pytest

from repro.distributed import monitor as JMON
from repro.distributed.monitor import Heartbeat as JHeartbeat
from repro_torch.distributed import monitor as MON
from repro_torch.distributed.monitor import Heartbeat


def test_public_names_match_reference():
    """Every class and function of the reference's monitor, with the same
    fields, methods and parameters."""
    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and callable(v)
                and getattr(v, "__module__", None) == mod.__name__}

    want, got = public(JMON), public(MON)
    assert set(want) == set(got)
    for name, obj in want.items():
        if isinstance(obj, type):
            assert ([f.name for f in dataclasses.fields(got[name])]
                    == [f.name for f in dataclasses.fields(obj)]), name
            assert ({k for k in vars(obj) if callable(vars(obj)[k])}
                    == {k for k in vars(got[name])
                        if callable(vars(got[name])[k])}), name
        else:
            assert (inspect.signature(got[name]).parameters.keys()
                    == inspect.signature(obj).parameters.keys()), name


def test_dead_peers_grouped_by_pod(tmp_path):
    d = str(tmp_path)
    beats = [Heartbeat(d, process_index=i, stale_after_s=0.05,
                       pod=i // 2) for i in range(4)]
    for hb in beats:
        hb.beat(step=7)
    time.sleep(0.1)
    # pod 1 (procs 2, 3) stays dead; pod 0 refreshes
    beats[0].beat(step=8)
    beats[1].beat(step=8)
    by_pod = beats[0].dead_peers_by_pod()
    assert sorted(by_pod) == [1]
    assert sorted(by_pod[1]) == [2, 3]
    assert all(age > 0.05 for age in by_pod[1].values())
    # the flat view still reports the same peers
    assert sorted(beats[0].dead_peers()) == [2, 3]


def test_heartbeat_pre_pod_files_default_to_pod_zero(tmp_path):
    """Old heartbeat files (no pod field) group under pod 0 instead of
    being dropped."""
    d = str(tmp_path)
    import json
    import os
    with open(os.path.join(d, "hb_5.json"), "w") as f:
        json.dump({"step": 1, "t": time.time() - 999}, f)
    hb = Heartbeat(d, process_index=0, stale_after_s=60.0)
    assert sorted(hb.dead_peers_by_pod()) == [0]
    assert 5 in hb.dead_peers_by_pod()[0]


# -- expected-peers roster (regression: a peer that died BEFORE its first
#    beat left no hb_*.json and was invisible forever) -------------------

def test_never_beaten_registered_peer_reports_age_inf(tmp_path):
    d = str(tmp_path)
    roster = {0: 0, 1: 0, 2: 1, 3: 1}
    hb = Heartbeat(d, process_index=0, stale_after_s=60.0,
                   expected_peers=roster)
    hb.beat(step=1)
    Heartbeat(d, process_index=1, pod=0).beat(step=1)
    # procs 2 and 3 (all of pod 1) never wrote a file
    dead = hb.dead_peers()
    assert sorted(dead) == [2, 3]
    assert all(age == float("inf") for age in dead.values())
    by_pod = hb.dead_peers_by_pod()
    assert sorted(by_pod) == [1] and sorted(by_pod[1]) == [2, 3]


def test_expected_peers_iterable_form(tmp_path):
    """A bare index iterable registers everyone under pod 0."""
    hb = Heartbeat(str(tmp_path), process_index=0, expected_peers=[0, 1])
    hb.beat(step=1)
    assert sorted(hb.dead_peers()) == [1]
    assert hb.dead_peers_by_pod() == {0: {1: float("inf")}}


def test_unparsable_beat_counts_as_never_beaten(tmp_path):
    """A corrupt heartbeat file is a suspect process, not a healthy one."""
    import os
    with open(os.path.join(str(tmp_path), "hb_1.json"), "w") as f:
        f.write("{not json")
    hb = Heartbeat(str(tmp_path), process_index=0, stale_after_s=60.0,
                   expected_peers={1: 2})
    assert hb.dead_peers_by_pod() == {2: {1: float("inf")}}


# -- run_with_restart (regressions: an exception before the first
#    checkpoint escaped as FileNotFoundError, bypassing max_restarts; and
#    a trailing num_steps % checkpoint_every tail was never saved) -------

def _restart_harness(tmp_path, num_steps, checkpoint_every,
                     fail_at=(), max_restarts=3):
    from repro_torch.distributed.monitor import run_with_restart
    saves = []
    failed = set()

    def step_fn(state, step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected crash at {step}")
        return state + 1, {}

    def save_fn(state, step):
        saves.append((int(state), step))

    def restore_fn():
        if not saves:
            raise FileNotFoundError("no checkpoints yet")
        state, step = saves[-1]
        return state, step

    state, step = run_with_restart(
        step_fn, 0, 0, num_steps, save_fn, restore_fn,
        checkpoint_every=checkpoint_every, max_restarts=max_restarts)
    return state, step, saves


def test_restart_before_first_checkpoint_falls_back_to_initial(tmp_path):
    """A crash at step 0 (no checkpoint on disk yet) must restart from
    the caller's initial state — pre-fix this escaped as an uncaught
    FileNotFoundError from restore_fn."""
    state, step, _ = _restart_harness(tmp_path, num_steps=5,
                                      checkpoint_every=10, fail_at={0})
    assert (state, step) == (5, 5)


def test_restart_budget_still_enforced_without_checkpoint(tmp_path):
    """The fallback must not bypass max_restarts accounting."""
    from repro_torch.distributed.monitor import run_with_restart

    def step_fn(state, step):
        raise RuntimeError("always")

    def restore_fn():
        raise FileNotFoundError

    with pytest.raises(RuntimeError, match="always"):
        run_with_restart(step_fn, 0, 0, 5, lambda s, i: None, restore_fn,
                         checkpoint_every=10, max_restarts=2)


def test_final_tail_state_always_saved(tmp_path):
    """num_steps % checkpoint_every != 0: the tail must still be saved on
    loop exit (pre-fix the last 3 steps of progress evaporated)."""
    state, step, saves = _restart_harness(tmp_path, num_steps=13,
                                          checkpoint_every=5)
    assert (state, step) == (13, 13)
    assert saves[-1] == (13, 13)
    assert (5, 5) in saves and (10, 10) in saves


def test_restart_replays_from_last_checkpoint(tmp_path):
    """The pre-existing contract still holds: a mid-run crash resumes
    from the newest checkpoint, exactly."""
    state, step, saves = _restart_harness(tmp_path, num_steps=12,
                                          checkpoint_every=4,
                                          fail_at={6})
    assert (state, step) == (12, 12)
    assert saves[-1] == (12, 12)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_roster_reads_the_same_in_both_packages(tmp_path, writer):
    """Beat files written by one package's Heartbeat: a fresh pod, a
    stale pod, a never-beaten peer and a retired one read as the same
    ``dead_peers_by_pod()`` in both packages."""
    d = str(tmp_path)
    make = JHeartbeat if writer == "reference" else Heartbeat
    roster = {0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 2}
    for i in (0, 1, 2, 3, 4):
        make(d, process_index=i, pod=roster[i]).beat(step=3)
    time.sleep(0.6)
    for i in (0, 1, 4):                    # pod 1 goes stale; 5 never beat
        make(d, process_index=i, pod=roster[i]).beat(step=4)
    got = {}
    for name, cls in (("reference", JHeartbeat), ("port", Heartbeat)):
        hb = cls(d, process_index=0, stale_after_s=0.5,
                 expected_peers=roster)
        hb.retire_peers([3])
        by_pod = hb.dead_peers_by_pod()
        got[name] = {pod: sorted(peers) for pod, peers in by_pod.items()}
        assert by_pod[2][5] == float("inf")
        assert hb.dead_peers().keys() == {2, 5}
    assert got["reference"] == got["port"] == {1: [2], 2: [5]}
