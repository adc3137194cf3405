"""The port's elastic pod loss and pod join against the JAX reference.

``repro_torch.launch.elastic`` rebuilds the system on the survivor
``(pods-1, shards)`` mesh (or the grown ``(pods+1, shards)`` one) and moves
only the state that changes node, vectorised on the state's device where
the reference walks each live ring row on the host. Held here, at REDUCED
sizes:

* ``survivor_config`` / ``join_config`` equal the reference's on every
  shared field, and refuse what the reference refuses with its messages;
* ``rehome_state`` and ``expand_state`` equal the reference's bit for bit,
  ``RehomeStats`` included, on the same state (numpy ``uint32`` in, through
  ``convert``): a collision-free stream state, and one with planted
  unsplittable rows and two source rows that land on one destination row
  (the write order decides), under "warn", and "fail" raising the
  reference's message with the count;
* the anchors of ``tests/test_elastic_equiv.py`` and
  ``tests/test_pod_join.py`` on the port alone: kill a pod mid-trace,
  recover from the snapshot and replay ≡ a clean run on the small mesh
  (state, replayed outputs and metrics bit for bit), V2 past 256 ports
  included; a mid-stream join ≡ a clean run on the large mesh;
* the moved state owns its tensors, and the survivor device is one device.
"""
import dataclasses
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import pod_mesh_or_skip
from repro.configs.dfa import REDUCED as JREDUCED
from repro.core import reporter as JREP
from repro.core import translator as JTRANS
from repro.core.pipeline import DFASystem as JSystem
from repro.data import scenarios as JSC
from repro.launch import elastic as JEL
from repro_torch import u32 as U
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import REDUCED
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.pipeline import DFASystem
from repro_torch.distributed.monitor import Heartbeat
from repro_torch.launch import elastic as EL
from test_torch_mesh2d import build_trace

TOTAL_PORTS = 4
EVENTS_PER_PORT = 48
T = 6
KILL_AT = 4
JOIN_AT = 3
SNAP_EVERY = 2
FPS = 512
REPORTER_SLOTS = 64
PORT_CAPACITY = 16
# the join suites' ring (tests/test_pod_join.py): at 512 rows two of
# elephants_mice's keys share a slot on one node of the grown roster
JOIN_FPS = 1024

_traces, _refs, _states = {}, {}, {}


def knobs(pods, nodes=(), policy="fail", **kw):
    return {**dict(flow_home="rendezvous", pods=pods,
                   ports_per_pod=TOTAL_PORTS // pods,
                   reporter_slots=REPORTER_SLOTS, flows_per_shard=FPS,
                   port_report_capacity=PORT_CAPACITY, home_nodes=nodes,
                   snapshot_every_periods=SNAP_EVERY,
                   rehome_collision_policy=policy), **kw}


def port(pods, shards, nodes=(), policy="fail", **kw):
    return DFASystem(dataclasses.replace(REDUCED, **knobs(pods, nodes, policy,
                                                          **kw)),
                     device="cpu", n_shards=pods * shards)


def ref(pods, shards, nodes=(), policy="fail", **kw):
    key = (pods, shards, nodes, policy, tuple(sorted(kw.items())))
    if key not in _refs:
        cfg = dataclasses.replace(JREDUCED, kernel_backend="ref",
                                  **knobs(pods, nodes, policy, **kw))
        _refs[key] = JSystem(cfg, pod_mesh_or_skip(pods, shards))
    return _refs[key]


def trace(name, ports=TOTAL_PORTS, per_port=EVENTS_PER_PORT):
    key = (name, ports, per_port)
    if key not in _traces:
        _traces[key] = build_trace(name, ports, per_port, T)
    return _traces[key]


def head(ev, nows, n):
    return {k: v[:n] for k, v in ev.items()}, nows[:n]


def tail(ev, nows, n):
    return {k: v[n:] for k, v in ev.items()}, nows[n:]


def merged(system, state):
    """Roster-canonical view (tests/test_elastic_equiv.py::_merged_state):
    reporter and tables as they are, ``last_seq`` max-merged over devices,
    the scalar counters summed."""
    st = state_to_numpy(state)
    n = system.n_shards
    out = {f"rep.{k}": v for k, v in st.reporter._asdict().items()}
    out["tr.hist_counter"] = st.translator.hist_counter
    c = st.collector
    out["coll.memory"] = c.memory
    out["coll.entry_valid"] = c.entry_valid
    out["coll.last_seq"] = c.last_seq.reshape(n, -1).max(0)
    for k in ("bad_checksum", "seq_anomalies", "received", "lost_reports"):
        out[f"coll.{k}"] = getattr(c, k).astype(np.uint64).sum()
    return out


def canon(out):
    per = []
    for t in range(out.enriched.shape[0]):
        m = out.mask[t]
        fid = out.flow_ids[t][m]
        order = torch.sort(fid, stable=True).indices
        per.append({"fid": fid[order].numpy(),
                    "enr": out.enriched[t][m][order].numpy()})
    return per


def assert_merged_equal(want, got, ctx):
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{ctx}: {k}")


def assert_tail_equal(clean, out, start, ctx):
    """The resumed run's outputs and metrics ≡ the clean run's from
    ``start`` on."""
    want, got = canon(clean)[start:], canon(out)
    assert len(want) == len(got) == T - start
    for t, (w, g) in enumerate(zip(want, got)):
        for k in w:
            np.testing.assert_array_equal(w[k], g[k],
                                          err_msg=f"{ctx}: {start + t} {k}")
    for k, v in out.metrics.items():
        np.testing.assert_array_equal(clean.metrics[k][start:].numpy(),
                                      v.numpy(), err_msg=f"{ctx}: metric {k}")


def assert_np_state_equal(want, got, ctx=""):
    """A reference numpy DFAState against the port's, leaf by leaf."""
    got = state_to_numpy(got)
    for group in ("reporter", "translator", "collector"):
        w, g = getattr(want, group), getattr(got, group)
        for f in type(g)._fields:
            a, b = np.asarray(getattr(w, f)), getattr(g, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (group, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx}{group}.{f}")


# -- configs and refusals ---------------------------------------------------

def public(mod):
    """The functions and classes ``mod`` defines (not imports), by name."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


def test_public_names_and_signatures_match_reference():
    want, got = public(JEL), public(EL)
    assert set(want) <= set(got), set(want) - set(got)
    for name, fn in want.items():
        if isinstance(fn, type):
            assert got[name]._fields == fn._fields, name
        else:
            assert (list(inspect.signature(got[name]).parameters)
                    == list(inspect.signature(fn).parameters)), name


def shared_fields(tcfg, jcfg):
    names = ({f.name for f in dataclasses.fields(tcfg)}
             & {f.name for f in dataclasses.fields(jcfg)}) - {"kernel_backend"}
    return ({k: getattr(tcfg, k) for k in names},
            {k: getattr(jcfg, k) for k in names})


@pytest.mark.parametrize("pods,shards,nodes,dead", [
    (2, 2, (), 0), (2, 2, (), 1), (2, 2, (0, 3, 5, 9), 1), (2, 1, (), 1)])
def test_survivor_config_matches_reference(pods, shards, nodes, dead):
    t, j = shared_fields(EL.survivor_config(port(pods, shards, nodes), dead),
                         JEL.survivor_config(ref(pods, shards, nodes), dead))
    assert t == j
    s = EL.survivor_system(port(pods, shards, nodes), dead)
    assert (s.mesh_pods, s.shards_per_pod, s.n_shards) == (
        pods - 1, shards, (pods - 1) * shards)
    assert s.total_ports == TOTAL_PORTS and s.device.type == "cpu"


@pytest.mark.parametrize("pods,shards,nodes,new", [
    (1, 2, (0, 1), (2, 3)), (1, 2, (0, 3), (5, 9)), (1, 1, (), (4,))])
def test_join_config_matches_reference(pods, shards, nodes, new):
    t, j = shared_fields(EL.join_config(port(pods, shards, nodes), new),
                         JEL.join_config(ref(pods, shards, nodes), new))
    assert t == j
    s = EL.join_system(port(pods, shards, nodes), new)
    assert s.mesh_pods == pods + 1 and s.home_nodes == tuple(nodes or
                                                             range(shards)) + new


REFUSALS = [
    ("survivor, hash home", "survivor_config", (2, 2, (), "hash"), (0,)),
    ("survivor, dead pod out of range", "survivor_config", (2, 2, ()), (5,)),
    ("survivor, negative pod", "survivor_config", (2, 2, ()), (-1,)),
    ("survivor, single pod", "survivor_config", (1, 2, ()), (0,)),
    ("survivor, ports do not spread", "survivor_config", (3, 1, ()), (0,)),
    ("join, one id per shard", "join_config", (1, 2, (0, 1)), ((2,),)),
    ("join, decreasing ids", "join_config", (1, 2, (0, 1)), ((3, 2),)),
    ("join, repeated ids", "join_config", (1, 2, (0, 1)), ((2, 2),)),
    ("join, ids below the roster", "join_config", (1, 2, (0, 1)), ((1, 2),)),
    ("join, ports do not spread", "join_config", (2, 2, (0, 1, 2, 3)),
     ((4, 5),)),
    ("join, hash home", "join_config", (1, 2, (), "hash"), ((2, 3),)),
]


@pytest.mark.parametrize("case,fn,system,args", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_match_reference(case, fn, system, args):
    pods, shards, nodes = system[:3]
    kw = {"flow_home": system[3]} if len(system) == 4 else {}
    errs = []
    for mk, mod in ((port, EL), (ref, JEL)):
        s = mk(pods, shards, nodes, **kw)
        with pytest.raises(ValueError) as e:
            getattr(mod, fn)(s, *args)
        errs.append(str(e.value))
    assert errs[0] == errs[1], case


def test_one_device_for_the_rebuilt_system():
    s = port(2, 2)
    assert EL.one_device(None, s.device) == torch.device("cpu")
    assert EL.one_device(["cpu"], "cuda") == torch.device("cpu")
    assert EL.one_device(torch.device("cpu"), "cuda").type == "cpu"
    with pytest.raises(ValueError, match="one-card emulation"):
        EL.one_device(["cpu", "cpu"], "cpu")
    with pytest.raises(ValueError, match="one-card emulation"):
        EL.survivor_system(s, 0, devices=[])
    if not torch.cuda.is_available():
        # no fallback: a survivor asked for on the card raises here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EL.survivor_system(s, 0, devices="cuda")


# -- rehome_state / expand_state against the reference ----------------------

def find_keys(nodes, want):
    """Deterministic five-tuples whose HRW winners over ``nodes`` are the
    positions ``want`` (in order), brute-forced."""
    arr = jnp.asarray(nodes, jnp.uint32)
    out = []
    for i in range(1, 1 << 14):
        key = np.asarray([i, i + 1, 7, 9, 11], np.uint32)
        pos = int(np.asarray(JTRANS.rendezvous_position(
            JREP.hash_u32(jnp.asarray(key[None, :])), arr))[0])
        if pos == want[len(out)]:
            out.append(key)
            if len(out) == len(want):
                return out
    raise AssertionError(f"no keys for positions {want} over {nodes}")


def plant(st, wf, fps, row_entries, seed=0):
    """Write ring rows into a numpy DFAState: ``row_entries`` maps a global
    row to [(entry, key), ...]; each planted entry gets random words (a
    random stats body, flow word and checksum) around its key, and the
    row a random history counter."""
    rng = np.random.default_rng(seed)
    mem = st.collector.memory.copy()
    ev = st.collector.entry_valid.copy()
    hist = st.translator.hist_counter.copy()
    for row, entries in row_entries.items():
        for h, key in entries:
            mem[row, h] = rng.integers(0, 1 << 32, mem.shape[-1],
                                       dtype=np.uint64).astype(np.uint32)
            mem[row, h, wf.payload_tuple_slice] = key
            ev[row, h] = True
        hist[row] = rng.integers(0, 10)
    return st._replace(
        collector=st.collector._replace(memory=mem, entry_valid=ev),
        translator=st.translator._replace(hist_counter=hist))


def ref_state(js, name, periods):
    """The reference's state after ``periods`` of ``name``, as numpy (with
    counters on every device, so the merge folds real values)."""
    key = (id(js), name, periods)
    if key not in _states:
        _states[key] = _ref_state(js, name, periods)
    return _states[key]


def _ref_state(js, name, periods):
    ev, nows = JSC.build(name, TOTAL_PORTS, EVENTS_PER_PORT, T)
    with js.mesh:
        out = js.stream(js.init_state(),
                        {k: jnp.asarray(v[:periods]) for k, v in ev.items()},
                        jnp.asarray(nows[:periods]))
    st = type(out.state)(*(type(g)(*(np.asarray(x) for x in g))
                           for g in out.state))
    # per-device scalar counters near 2^32, so the fold into survivor 0
    # wraps
    c = st.collector
    return st._replace(collector=c._replace(
        received=(c.received + np.uint32(0xFFFFFF00)),
        lost_reports=c.lost_reports + np.arange(len(c.lost_reports),
                                                dtype=np.uint32)))


def both_moves(fn, st, jold, jnew, told, tnew, *args):
    """``fn`` of both packages on the same numpy state; returns (ref
    state, ref stats, port state, port stats, the warnings' messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jst, jstats = getattr(JEL, fn)(st, jold, jnew, *args)
        tst, tstats = getattr(EL, fn)(state_from_numpy(st, device="cpu"),
                                      told, tnew, *args)
    return jst, jstats, tst, tstats, [str(w.message) for w in caught
                                      if "cannot be split" in str(w.message)]


@pytest.mark.parametrize("planted", ["stream state", "collisions"])
@pytest.mark.parametrize("dead", [0, 1])
def test_rehome_state_matches_reference(dead, planted):
    policy = "warn" if planted == "collisions" else "fail"
    jold = ref(2, 2, (0, 1, 2, 3))
    survivors = (2, 3) if dead == 0 else (0, 1)
    jnew = ref(1, 2, survivors, policy)
    told, tnew = port(2, 2, (0, 1, 2, 3)), port(1, 2, survivors, policy)
    st = ref_state(jold, "cross_pod_mix", KILL_AT)
    if planted == "collisions":
        wf, base = told.wire, dead * 2 * FPS
        split = find_keys(survivors, [0, 1])        # disagree on a home
        same = find_keys(survivors, [1, 1])         # agree: one dst row
        st = plant(st, wf, FPS, {
            base + 5: [(0, split[0]), (3, split[1])],
            # dead nodes' rows 9 land on one survivor row; entries 2 and
            # 4 overlap, so the second dead node's writes must win there
            base + 9: [(2, same[0]), (4, same[0]), (6, same[0])],
            base + FPS + 9: [(1, same[1]), (2, same[1]), (4, same[1])]})
    jst, jstats, tst, tstats, msgs = both_moves(
        "rehome_state", st, jold, jnew, told, tnew, dead)
    assert tuple(tstats) == tuple(jstats)
    assert jstats.moved_rows > 0
    if planted == "collisions":
        assert jstats.unsplittable_collisions == 1
        assert len(msgs) == 2 and msgs[0] == msgs[1]
    else:
        assert jstats.unsplittable_collisions == 0 and not msgs
    assert_np_state_equal(jst, tst)


def test_rehome_state_fail_policy_raises_the_count():
    jold, jnew = ref(2, 2, (0, 1, 2, 3)), ref(1, 2, (2, 3))
    told, tnew = port(2, 2, (0, 1, 2, 3)), port(1, 2, (2, 3))
    st = jax_init(jold)
    a, b = find_keys((2, 3), [0, 1])
    c, d = find_keys((2, 3), [1, 0])
    st = plant(st, told.wire, FPS, {5: [(0, a), (1, b)],
                                    FPS + 7: [(3, c), (8, d)]})
    errs = []
    for mod, (o, n), s in ((JEL, (jold, jnew), st),
                           (EL, (told, tnew), state_from_numpy(st,
                                                               device="cpu"))):
        with pytest.raises(RuntimeError, match="cannot be split") as e:
            mod.rehome_state(s, o, n, 0)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "2 ring slot(s)" in errs[0]


def jax_init(js):
    st = js.init_state()
    return type(st)(*(type(g)(*(np.asarray(x) for x in g)) for g in st))


@pytest.mark.parametrize("planted", ["stream state", "collisions"])
def test_expand_state_matches_reference(planted):
    policy = "warn" if planted == "collisions" else "fail"
    kw = {"flows_per_shard": JOIN_FPS}
    jold, jnew = ref(1, 2, (0, 1), **kw), ref(2, 2, (0, 1, 2, 3), policy, **kw)
    told, tnew = (port(1, 2, (0, 1), **kw),
                  port(2, 2, (0, 1, 2, 3), policy, **kw))
    st = ref_state(jold, "elephants_mice", JOIN_AT)
    if planted == "collisions":
        split = find_keys((0, 1, 2, 3), [0, 2])
        same = find_keys((0, 1, 2, 3), [3, 3])
        st = plant(st, told.wire, JOIN_FPS, {
            11: [(0, split[0]), (7, split[1])],
            # both old nodes' rows 13 move to node 3's row 13
            13: [(0, same[0]), (5, same[0])],
            JOIN_FPS + 13: [(5, same[1]), (9, same[1])]})
    jst, jstats, tst, tstats, msgs = both_moves(
        "expand_state", st, jold, jnew, told, tnew)
    assert tuple(tstats) == tuple(jstats)
    assert 0 < jstats.moved_rows < jstats.scanned_rows
    assert jstats.unsplittable_collisions == (planted == "collisions")
    assert len(msgs) == (2 if planted == "collisions" else 0)
    assert_np_state_equal(jst, tst)


def test_expand_state_fail_and_unknown_policy():
    jold = ref(1, 2, (0, 1))
    told = port(1, 2, (0, 1))
    a, b = find_keys((0, 1, 2, 3), [1, 2])
    st = plant(jax_init(jold), told.wire, FPS, {3: [(0, a), (1, b)]})
    for policy, exc, match in (("fail", RuntimeError, "cannot be split"),
                               ("explode", ValueError,
                                "rehome_collision_policy")):
        errs = []
        for mod, o, n, s in (
                (JEL, jold, ref(2, 2, (0, 1, 2, 3), policy), st),
                (EL, told, port(2, 2, (0, 1, 2, 3), policy),
                 state_from_numpy(st, device="cpu"))):
            with pytest.raises(exc, match=match) as e:
                mod.expand_state(s, o, n)
            errs.append(str(e.value))
        assert errs[0] == errs[1], policy


def test_moved_state_owns_its_tensors():
    """Nothing of the input state reaches the moved one: scribbling over
    every input tensor afterwards leaves the output as it was."""
    ev, nows = head(*trace("cross_pod_mix"), KILL_AT)
    full, small = port(2, 2, (0, 1, 2, 3)), port(1, 2, (0, 1))
    for fn, src_sys, args in (("rehome_state", full, (port(1, 2, (2, 3)), 0)),
                              ("expand_state", small, (full,))):
        src = src_sys.run_periods(src_sys.init_state(), ev, nows).state
        out, _ = getattr(EL, fn)(src, src_sys, *args)
        snap = [x.clone() for g in out for x in g]
        for g in src:
            for x in g:
                x.fill_(True if x.dtype == torch.bool else -7)
        for a, b in zip(snap, (x for g in out for x in g)):
            assert torch.equal(a, b), fn


# -- the recovery anchors on the port -----------------------------------------

def kill_and_recover(name, dead, snap_dir, ports=TOTAL_PORTS,
                     per_port=EVENTS_PER_PORT, **kw):
    ev, nows = trace(name, ports, per_port)
    full = port(2, 2, **kw)
    full.stream(full.init_state(), *head(ev, nows, KILL_AT),
                snapshot_dir=snap_dir)
    new, state, period = EL.recover_from_snapshot(full, snap_dir, dead,
                                                  devices="cpu")
    assert period == KILL_AT
    assert new.last_rehome_stats.moved_rows > 0
    assert set(new.last_recovery_us) == {"restore", "rehome"}
    out = new.stream(state, *tail(ev, nows, period))
    return new, out


@pytest.mark.parametrize("name,dead", [("cross_pod_mix", 0),
                                       ("elephants_mice", 0),
                                       ("flow_churn", 0),
                                       ("cross_pod_mix", 1)])
def test_kill_a_pod_matches_clean_small_mesh(name, dead, tmp_path):
    new, out = kill_and_recover(name, dead, str(tmp_path))
    survivors = (2, 3) if dead == 0 else (0, 1)
    assert new.home_nodes == survivors
    clean_sys = port(1, 2, survivors)
    clean = clean_sys.stream(clean_sys.init_state(), *trace(name))
    assert int(clean.metrics["reports_recv"].sum()) > 0
    assert_merged_equal(merged(clean_sys, clean.state),
                        merged(new, out.state), name)
    assert_tail_equal(clean, out, KILL_AT, name)


V2_PORTS = 264
V2_EVENTS_PER_PORT = 4


def test_v2_kill_a_pod_past_256_ports(tmp_path):
    v2 = dict(wire_format="v2", ports_per_pod=V2_PORTS // 2,
              flows_per_shard=1024, reporter_slots=32,
              port_report_capacity=32)
    ev, nows = trace("elephants_mice", V2_PORTS, V2_EVENTS_PER_PORT)
    full = DFASystem(dataclasses.replace(port(2, 2).cfg, **v2), device="cpu",
                     n_shards=4)
    assert full.wire.name == "v2" and full.total_ports == V2_PORTS
    full.stream(full.init_state(), *head(ev, nows, KILL_AT),
                snapshot_dir=str(tmp_path))
    new, state, period = EL.recover_from_snapshot(full, str(tmp_path), 0,
                                                  devices="cpu")
    assert new.home_nodes == (2, 3) and new.total_ports == V2_PORTS
    out = new.stream(state, *tail(ev, nows, period))
    clean_sys = DFASystem(dataclasses.replace(
        port(1, 2, (2, 3)).cfg, **dict(v2, ports_per_pod=V2_PORTS)),
        device="cpu", n_shards=2)
    clean = clean_sys.stream(clean_sys.init_state(), ev, nows)
    got = merged(new, out.state)
    assert (got["rep.seq"][256:] > 0).any()
    assert_merged_equal(merged(clean_sys, clean.state), got, "v2")
    assert_tail_equal(clean, out, KILL_AT, "v2")


def grow(name):
    ev, nows = trace(name)
    small = port(1, 2, (0, 1), flows_per_shard=JOIN_FPS)
    pre = small.stream(small.init_state(), *head(ev, nows, JOIN_AT))
    big = EL.join_system(small, (2, 3))
    assert big.mesh_pods == 2 and big.home_nodes == (0, 1, 2, 3)
    assert big.total_ports == TOTAL_PORTS and big.n_shards == 4
    grown, stats = EL.expand_state(pre.state, small, big)
    return big, big.stream(grown, *tail(ev, nows, JOIN_AT)), stats


@pytest.mark.parametrize("name", ["cross_pod_mix", "elephants_mice"])
def test_grow_matches_clean_large_mesh(name):
    big, out, stats = grow(name)
    assert stats.moved_rows > 0 and stats.unsplittable_collisions == 0
    assert stats.moved_rows <= 0.75 * stats.scanned_rows
    clean_sys = port(2, 2, (0, 1, 2, 3), flows_per_shard=JOIN_FPS)
    clean = clean_sys.stream(clean_sys.init_state(), *trace(name))
    assert_merged_equal(merged(clean_sys, clean.state),
                        merged(big, out.state), name)
    assert_tail_equal(clean, out, JOIN_AT, name)


def test_heartbeat_trigger_and_maybe_recover(tmp_path):
    """A registered pod that never beats trips ``whole_dead_pods``;
    ``maybe_recover`` rebuilds without it, and ignores a listed pod."""
    snap = str(tmp_path / "snap")
    ev, nows = trace("cross_pod_mix")
    full = port(2, 2)
    full.stream(full.init_state(), *head(ev, nows, KILL_AT),
                snapshot_dir=snap)
    hb_dir = str(tmp_path / "hb")
    hb = Heartbeat(hb_dir, process_index=0, stale_after_s=60.0,
                   expected_peers={0: 0, 1: 0, 2: 1, 3: 1})
    hb.beat(step=1)
    Heartbeat(hb_dir, process_index=1, pod=0).beat(step=1)
    assert EL.whole_dead_pods(hb) == [1]
    assert EL.maybe_recover(hb, full, snap, ignore_pods=[1]) is None
    new, state, period = EL.maybe_recover(hb, full, snap, devices="cpu")
    assert period == KILL_AT and new.home_nodes == (0, 1)
    d = new.describe()
    assert d["home_nodes"] == (0, 1) and d["pods"] == 1
    assert d["rehome_collision_policy"] == "fail"
    assert int(U.wide(state.collector.received).sum()) > 0
    # restored from the snapshot on disk: CKPT keeps the newest
    assert CKPT.latest_step(snap) == KILL_AT
