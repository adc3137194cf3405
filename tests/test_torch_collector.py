"""The port's translator, collector and ring_scatter family against JAX.

History addressing, translation, routing (with a hostile flow id parked
as a misroute), and collector ingest with corrupted checksums, replays
inside the §VI-B window, in-batch duplicates and seq gaps. The plain
version of the CUDA ring_scatter kernel is held against
``ring_scatter_pallas(interpret=True)`` plus the reference's jnp
entry_valid update, including batches where several rows hit one
(flow, hist) cell. Integers bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.core import collector as JC
from repro.core import protocol as JPROTO
from repro.core import translator as JTR
from repro.kernels.ring_scatter.kernel import ring_scatter_pallas
from repro.kernels.ring_scatter.ops import ring_scatter_collector
from repro_torch.configs import REDUCED
from repro_torch.core import collector as TC
from repro_torch.core import translator as TTR
from repro_torch.kernels.ring_scatter import ops as RS
from test_torch_leaves import T, assert_same, rand_u32

JCFG = get_dfa_config(reduced=True)
F, H = REDUCED.flows_per_shard, REDUCED.history


def make_reports(rng, R, n_flows=F, seq0=0, rid=0):
    flow = rng.integers(0, n_flows, R).astype(np.uint32)
    stats = rng.integers(0, 1 << 20, (R, 7)).astype(np.uint32)
    tup = rand_u32(rng, (R, 5))
    seq = (seq0 + np.arange(R)).astype(np.uint32)
    return np.array(JPROTO.pack_dta_report(
        jnp.asarray(flow), jnp.full((R,), rid, jnp.uint32), jnp.asarray(seq),
        jnp.asarray(stats), jnp.asarray(tup)))


def test_compute_addresses_and_translate(rng):
    R = 96
    reports = make_reports(rng, R, n_flows=20)       # many reports per flow
    mask = rng.random(R) < 0.8
    counter = rng.integers(0, H, F).astype(np.uint32)
    jst = JTR.TranslatorState(jnp.asarray(counter))
    tst = TTR.TranslatorState(T(counter))
    js, jp, jc = JTR.translate(jst, jnp.asarray(reports), jnp.asarray(mask),
                               0, JCFG)
    ts, tp, tc = TTR.translate(tst, T(reports), T(mask), 0, REDUCED)
    assert_same(js.hist_counter, ts.hist_counter)
    assert_same(jp, tp)
    for k in ("local_flow", "hist", "mask"):
        assert_same(jc[k], tc[k], k)


@pytest.mark.parametrize("n_shards,cap", [(1, 128), (1, 5), (4, 8)])
def test_route_reports_parks_misroutes(rng, n_shards, cap):
    R = 64
    fps = 64
    reports = make_reports(rng, R, n_flows=n_shards * fps)
    reports[3, 0] = 0xFFFFFFF0                 # hostile id: negative as i32
    reports[7, 0] = n_shards * fps + 5         # beyond the keyspace
    mask = rng.random(R) < 0.9
    mask[[3, 7]] = True
    want = JTR.route_reports(jnp.asarray(reports), jnp.asarray(mask),
                             n_shards, fps, cap)
    got = TTR.route_reports(T(reports), T(mask), n_shards, fps, cap)
    for n, a, b in zip(("buckets", "mask", "misroutes"), want, got):
        assert_same(a, b, n)
    assert int(got[2]) == 2


def payload_batch(rng, R, flows, seqs, rid=0):
    reports = make_reports(rng, R)
    reports[:, 0] = flows
    reports = np.asarray(JPROTO.pack_dta_report(
        jnp.asarray(reports[:, 0]), jnp.full((R,), rid, jnp.uint32),
        jnp.asarray(seqs, jnp.uint32), jnp.asarray(reports[:, 2:9]),
        jnp.asarray(reports[:, 9:14])))
    _, pays, _ = JTR.translate(JTR.init_state(JCFG),
                                    jnp.asarray(reports),
                                    jnp.ones(R, bool), 0, JCFG)
    return np.asarray(pays).copy()


def test_collector_ingest_integrity(rng):
    """Bad checksums rejected and counted; a replay inside the dup window
    and an in-batch duplicate rejected (first arrival wins); a seq gap
    counts as lost reports — identically to the reference."""
    R = 48
    flows = rng.integers(0, F, R).astype(np.uint32)
    seqs = np.arange(10, 10 + R) % 256
    seqs[5] = seqs[4]                          # in-batch duplicate
    seqs[20:] += 3                             # a gap of three
    seqs[30] = 8                               # replay below the window top
    pays = payload_batch(rng, R, flows, seqs % 256)
    pays[11, 4] ^= 0x40                        # corrupted in flight
    pays[12, 14] ^= 1                          # corrupted checksum word
    mask = np.ones(R, bool)
    mask[40] = False
    last_seq = np.zeros(256, np.uint32)
    last_seq[0] = 10                           # reporter 0 saw seq 9
    jst = JC.init_state(JCFG)._replace(last_seq=jnp.asarray(last_seq))
    tst = TC.init_state(REDUCED)._replace(last_seq=T(last_seq))
    want = JC.ingest(jst, jnp.asarray(pays), jnp.asarray(mask), 0, JCFG,
                     scatter_fn=JC.scatter_ref)
    got = TC.ingest(tst, T(pays), T(mask), 0, REDUCED)
    for f in TC.CollectorState._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert int(got.bad_checksum) == 2 and int(got.seq_anomalies) >= 2


def scatter_case(rng, R, n_cells):
    mem = rand_u32(rng, (F, H, 16))
    ev = rng.random((F, H)) < 0.3
    pays = rand_u32(rng, (R, 16))
    if n_cells:                                # few cells, many writers
        cell = rng.integers(0, n_cells, R)
        flow, hist = (cell * 37) % F, cell % H
    else:
        flow, hist = rng.integers(0, F, R), rng.integers(0, H, R)
    mask = rng.random(R) < 0.8
    return mem, ev, pays, flow.astype(np.int32), hist.astype(np.int32), mask


@pytest.mark.parametrize("R,n_cells", [(128, 0), (128, 6), (37, 3)])
def test_ring_scatter_plain_matches_pallas(rng, R, n_cells):
    mem, ev, pays, flow, hist, mask = scatter_case(rng, R, n_cells)
    jm = ring_scatter_pallas(jnp.asarray(mem), jnp.asarray(pays),
                             jnp.asarray(flow), jnp.asarray(hist),
                             jnp.asarray(mask), flow_tile=64, history=H,
                             interpret=True)
    _, jev = ring_scatter_collector(jnp.asarray(mem), jnp.asarray(ev),
                                    jnp.asarray(pays), jnp.asarray(flow),
                                    jnp.asarray(hist), jnp.asarray(mask),
                                    backend="ref")
    tm, tev = T(mem), T(ev)
    got_m, got_ev = RS.ring_scatter(tm, tev, T(pays), torch.from_numpy(flow),
                                    torch.from_numpy(hist), T(mask))
    assert got_m.data_ptr() == tm.data_ptr()   # placement is in place
    assert_same(jm, got_m)
    assert_same(jev, got_ev)


def test_ring_scatter_last_write_wins_explicit():
    """Three rows to one cell: the LAST masked one lands."""
    mem = np.zeros((4, 2, 16), np.uint32)
    ev = np.zeros((4, 2), bool)
    pays = np.arange(4 * 16, dtype=np.uint32).reshape(4, 16)
    flow = np.array([1, 1, 1, 2], np.int32)
    hist = np.array([0, 0, 0, 1], np.int32)
    mask = np.array([True, True, False, True])
    m, e = RS.ring_scatter(T(mem), T(ev), T(pays), torch.from_numpy(flow),
                           torch.from_numpy(hist), T(mask))
    assert_same(pays[1], m[1, 0])
    assert_same(pays[3], m[2, 1])
    assert e.sum().item() == 2
