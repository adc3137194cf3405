"""The port's reporter and ingest_update family against the JAX reference.

``hash_slot``, first-come admission, ``due_flows`` tie order and
``make_reports``; then both ingest paths of the port — the multipass
oracle (``backend="ref"``) and the fused sort-once path whose segment
sums are the CUDA kernel's plain version on the CPU — against the
reference's multipass ``ref`` on the corners of
``tests/test_ingest_update_equiv.py``, and against its Pallas kernels in
interpret mode. The plain ``segment_sums`` must equal
``segment_sums_pallas(interpret=True)``'s (Ep, 8) output bit for bit.
All integer: no tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.core import reporter as JR
from repro.kernels.ingest_update import kernel as JK
from repro.kernels.ingest_update.ops import ingest_update as j_ingest
from repro_torch.configs import REDUCED
from repro_torch.core import reporter as TR
from repro_torch.kernels.ingest_update import kernel as TK
from repro_torch.kernels.ingest_update import ops as TO
from test_ingest_update_equiv import make_events, make_state
from test_torch_leaves import T, assert_same

OUT = ("regs", "last_ts", "keys", "active", "collisions")


def both_cfgs(**kw):
    return (dataclasses.replace(get_dfa_config(reduced=True), **kw),
            dataclasses.replace(REDUCED, **kw))


def port_state(st):
    return TR.ReporterState(*(T(getattr(st, f)).reshape(
        np.asarray(getattr(st, f)).shape) for f in TR.ReporterState._fields))


def port_args(st, ev, F):
    slots = TR.hash_slot(T(ev["five_tuple"]), F)
    return (T(st.regs), T(st.last_ts), T(st.keys), T(st.active),
            T(st.collisions).reshape(()), slots, T(ev["ts"]), T(ev["size"]),
            T(ev["five_tuple"]), T(ev["valid"]))


def jax_args(st, ev, F):
    slots = JR.hash_slot(ev["five_tuple"], F)
    return (st.regs, st.last_ts, st.keys, st.active, st.collisions, slots,
            ev["ts"], ev["size"], ev["five_tuple"], ev["valid"])


# name -> (flows_per_shard, E, n_keys, invalid_frac, ts_base, occupancy,
#          event_tile)
CORNERS = {
    "first_packet_runs": (256, 96, 12, 0.0, 0, 0.0, 64),
    "occupied_collisions": (256, 128, 10, 0.0, 0, 0.6, 64),
    "mid_block_u32_wrap": (256, 64, 5, 0.0, (1 << 32) - 30_000, 0.0, 64),
    "heavy_16_slot_table": (16, 200, 40, 0.0, 0, 0.5, 64),
    "all_invalid_block": (256, 64, 8, 1.1, 0, 0.3, 64),
    "E_not_multiple_of_tile": (256, 100, 25, 0.2, 0, 0.3, 32),
    "odd_tile": (256, 100, 25, 0.2, 0, 0.3, 7),
    "in_block_duplicate_install": (8, 48, 24, 0.0, 0, 0.0, 64),
}


def make_corner(rng, name):
    F, E, nk, inv, tsb, occ, tile = CORNERS[name]
    jcfg, tcfg = both_cfgs(flows_per_shard=F, event_tile=tile)
    st = make_state(rng, jcfg, occ) if occ else JR.init_state(jcfg)
    ev = make_events(rng, E, nk, inv, tsb)
    return jcfg, tcfg, st, ev


@pytest.mark.parametrize("name", sorted(CORNERS))
@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_ingest_paths_match_jax_ref(rng, name, backend):
    """Port multipass (ref) and fused (auto) ingest == JAX multipass ref."""
    jcfg, tcfg, st, ev = make_corner(rng, name)
    F = jcfg.flows_per_shard
    want = j_ingest(*jax_args(st, ev, F), jcfg, backend="ref")
    got = TO.ingest_update(*port_args(st, ev, F), tcfg, backend=backend)
    for n, a, b in zip(OUT, want, got):
        assert_same(a, b, f"{backend}: {n}")


@pytest.mark.parametrize("name", ["mid_block_u32_wrap", "odd_tile"])
def test_fused_ingest_matches_jax_interpret_kernels(rng, name):
    """Port fused path == ingest_update_pallas and ingest_update_hbm_pallas
    in interpret mode (full register state)."""
    jcfg, tcfg, st, ev = make_corner(rng, name)
    F = jcfg.flows_per_shard
    got = TO.ingest_update(*port_args(st, ev, F), tcfg)
    for kfn in (JK.ingest_update_pallas, JK.ingest_update_hbm_pallas):
        want = kfn(*jax_args(st, ev, F), logstar_bits=jcfg.logstar_bits,
                   event_tile=JK.clamp_tile(jcfg.event_tile, ev["ts"].shape[0]),
                   interpret=True)
        for n, a, b in zip(OUT, want, got):
            assert_same(a, b, f"{kfn.__name__}: {n}")


@pytest.mark.parametrize("name", ["mid_block_u32_wrap", "heavy_16_slot_table",
                                  "E_not_multiple_of_tile"])
def test_segment_sums_plain_matches_pallas_bitwise(rng, name):
    """The kernel's plain version == segment_sums_pallas (Ep, 8) output."""
    jcfg, tcfg, st, ev = make_corner(rng, name)
    F = jcfg.flows_per_shard
    js = JK.stream_prep(st.last_ts, st.keys, st.active,
                        JR.hash_slot(ev["five_tuple"], F), ev["ts"],
                        ev["size"], ev["five_tuple"], ev["valid"],
                        jcfg.event_tile)
    want = JK.segment_sums_pallas(js.s_slot, js.s_ts, js.s_ps, js.base_ts,
                                  js.first.astype(jnp.int32),
                                  bits=jcfg.logstar_bits, event_tile=js.tile,
                                  interpret=True)
    a = port_args(st, ev, F)
    ts_ = TK.stream_prep(a[1], a[2], a[3], a[5], a[6], a[7], a[8], a[9],
                         tcfg.event_tile)
    for f in ("s_slot", "s_ts", "s_ps", "base_ts", "first", "run_tail",
              "install", "collide"):
        assert_same(getattr(js, f), getattr(ts_, f), f)
    got = TO.segment_sums(ts_.s_slot, ts_.s_ts, ts_.s_ps, ts_.base_ts,
                          ts_.first.to(torch.int32), bits=tcfg.logstar_bits,
                          tile=ts_.tile)
    assert tuple(got.shape) == tuple(want.shape)
    assert_same(want, got)


@pytest.mark.parametrize("n_slots", [256, 1 << 17, 100, 177])
def test_hash_slot(rng, n_slots):
    tup = rng.integers(0, 1 << 32, size=(500, 5), dtype=np.uint64).astype(
        np.uint32)
    assert_same(JR.hash_slot(jnp.asarray(tup), n_slots),
                TR.hash_slot(T(tup), n_slots))
    assert_same(JR.hash_u32(jnp.asarray(tup)), TR.hash_u32(T(tup)))


@pytest.mark.parametrize("reverse", [False, True])
def test_admit_first_come_winner(rng, reverse):
    """Several new flows hashing to one empty slot in one block: the FIRST
    arrival installs, later different keys collide."""
    F = 8
    keys = np.zeros((F, 5), np.uint32)
    active = np.zeros(F, bool)
    active[5] = True
    keys[5] = 7
    tup = rng.integers(1, 1 << 31, size=(12, 5)).astype(np.uint32)
    tup[3] = tup[0]                                   # same key twice
    slots = np.array([2, 2, 3, 2, 5, 5, 2, 3, 1, 1, 2, 6], np.int64)
    if reverse:
        tup, slots = tup[::-1].copy(), slots[::-1].copy()
    valid = np.ones(12, bool)
    valid[7] = False
    want = JR.admit_arrays(jnp.asarray(keys), jnp.asarray(active),
                           jnp.uint32(0), jnp.asarray(slots, jnp.int32),
                           jnp.asarray(tup), jnp.asarray(valid))
    got = TR.admit_arrays(T(keys), T(active), torch.tensor(0, dtype=torch.int32),
                          torch.from_numpy(slots), T(tup), T(valid))
    for n, a, b in zip(("keys", "active", "collisions"), want, got):
        assert_same(a, b, n)
    assert int(got[2]) > 0


@pytest.mark.parametrize("capacity", [4, 16, 17, 40])
def test_due_flows_ties_and_padding(capacity):
    """Tied elapsed scores keep the lower slot first (JAX top_k order);
    capacity beyond F pads with masked rows."""
    jcfg, tcfg = both_cfgs(flows_per_shard=16, monitoring_period_us=1000)
    last = np.array([5, 9, 9, 5, 9, 0, 5, 3, 9, 9, 1, 0, 0, 2, 7, 9],
                    np.uint32) * 1000
    active = np.ones(16, bool)
    active[[2, 7]] = False
    st = JR.init_state(jcfg)._replace(last_report=jnp.asarray(last),
                                      active=jnp.asarray(active))
    now = 20_000
    ws, wm = JR.due_flows(st, jnp.uint32(now), jcfg, capacity)
    gs, gm = TR.due_flows(port_state(st), now, tcfg, capacity)
    assert_same(ws, gs)
    assert_same(wm, gm)
    # the probe from the porting notes: stable descending == top_k
    score = torch.tensor([5, 9, 9, 5, 9, 0, 5])
    assert torch.sort(score, descending=True, stable=True
                      ).indices[:4].tolist() == [1, 2, 4, 0]


def test_due_flows_zero_period_reports_zero_elapsed():
    jcfg, tcfg = both_cfgs(flows_per_shard=16, monitoring_period_us=0)
    st = JR.init_state(jcfg)._replace(active=jnp.ones(16, bool))
    ws, wm = JR.due_flows(st, jnp.uint32(0), jcfg, 8)
    gs, gm = TR.due_flows(port_state(st), 0, tcfg, 8)
    assert_same(ws, gs)
    assert_same(wm, gm)
    assert bool(gm.all())


def test_make_reports(rng):
    jcfg, tcfg = both_cfgs()
    st = make_state(rng, jcfg, 0.5)._replace(seq=jnp.uint32(250))
    slots = rng.choice(jcfg.flows_per_shard, 40, replace=False)
    mask = rng.random(40) < 0.7
    now = 0xFFFFFF00                              # near the u32 wrap
    ws, wr = JR.make_reports(st, jnp.asarray(slots, jnp.int32),
                             jnp.asarray(mask), jnp.uint32(now), 3, 0, jcfg)
    gs, gr = TR.make_reports(port_state(st), torch.from_numpy(slots),
                             T(mask), now, 3, 0, tcfg)
    assert_same(wr, gr)
    for f in ("last_report", "seq"):
        assert_same(getattr(ws, f), getattr(gs, f), f)


def test_state_level_ingest_matches(rng):
    """reporter.ingest (hash + route through the family) == JAX."""
    jcfg, tcfg = both_cfgs()
    st = make_state(rng, jcfg, 0.4)
    ev = make_events(rng, 96, n_keys=9, invalid_frac=0.1)
    want = JR.ingest(st, ev, jcfg, backend="ref")
    got = TR.ingest(port_state(st), {k: T(v) for k, v in ev.items()}, tcfg)
    for f in OUT:
        assert_same(getattr(want, f), getattr(got, f), f)
