"""The V2 wire on the port's single-shard pipeline, against the JAX
reference.

At ``REDUCED_V2_WIDE`` (512 reports per period from 4096 flows, past
V1's 256-value seq) the port matches the reference period by period
under V2 and under V1: every state leaf and metric bit for bit, features
by the row-scaled 1e-5 rule against the reference oracle run op by op.
Under V1 both packages reject the same in-batch duplicates; under V2
neither rejects any. Past the wrap of V2's 16-bit seq (140 periods of
512 reports) both packages give the same counters and state. Also:
``describe()``'s keys and ``translator.batch_payloads``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import translator as JT
from repro.kernels.gather_enrich.ref import gather_enrich_ref
from repro_torch.configs import REDUCED, REDUCED_V2_WIDE
from repro_torch.core import translator as TT
from repro_torch.core.pipeline import DFASystem
from test_torch_pipeline import (assert_outputs_equal, assert_state_equal,
                                 jax_system, traces)

WIDE = {"flows_per_shard": REDUCED_V2_WIDE.flows_per_shard,
        "report_capacity": REDUCED_V2_WIDE.report_capacity}
EVENTS = 2048
N_FLOWS = 1500


def systems(wire):
    js = jax_system(wire_format=wire, **WIDE)
    ts = DFASystem(dataclasses.replace(REDUCED_V2_WIDE, wire_format=wire),
                   device="cpu")
    return js, ts


def eager_features(js, jout):
    """The reference oracle, op by op, on the period's ring and flows."""
    m = np.asarray(jout.mask)
    lf = np.where(m, np.asarray(jout.flow_ids), 0).astype(np.int32)
    with jax.disable_jit():
        feats = gather_enrich_ref(jout.state.collector.memory,
                                  jout.state.collector.entry_valid,
                                  jnp.asarray(lf), js.cfg)
    return np.where(m[:, None], np.asarray(feats), 0.0)


@pytest.mark.parametrize("wire", ["v2", "v1"])
def test_wide_period_by_period_matches_jax(wire):
    js, ts = systems(wire)
    jev, jnows, tev, tnows = traces(T=4, E=EVENTS, n_flows=N_FLOWS,
                                    flow_seed=1)
    jstate, tstate = js.init_state(), ts.init_state()
    step = jax.jit(js.dfa_step)
    anomalies = []
    with js.mesh:
        for t in range(4):
            jout = step(jstate, {k: v[t] for k, v in jev.items()}, jnows[t])
            tout = ts.dfa_step(tstate, {k: v[t] for k, v in tev.items()},
                               tnows[t])
            jstate, tstate = jout.state, tout.state
            assert_state_equal(jstate, tstate, f"{wire} period {t}: ")
            assert_outputs_equal(jout, tout,
                                 features=eager_features(js, jout))
            assert int(tout.metrics["reports_sent"]) == 512
            anomalies.append(int(tout.metrics["seq_anomalies"]))
    if wire == "v2":
        assert anomalies == [0, 0, 0, 0]
    else:
        # 512 reports over 256 seq values: every value repeats
        assert min(anomalies) >= 256, anomalies


def test_past_the_v2_seq_wrap_matches_jax():
    """140 periods of 512 reports carry 71,680 seqs, past 65,536. Both
    packages give the same counters and state. After the wrap the
    collector's seq window stays at 65,536 (an amax), so wrapped seqs are
    neither fresh nor duplicates: the window stops advancing while
    reports keep landing, and the global seq-gap count (advance minus
    arrivals) goes negative, 2^32 - 512 per period, in both packages.
    The next test enters the duplicate window."""
    T = 140
    js, ts = systems("v2")
    jev, jnows, tev, tnows = traces(T=T, E=256, n_flows=N_FLOWS,
                                    flow_seed=1)
    # 256 events per period from 1500 flows: enough active flows after
    # the first periods to send the full 512 reports each period
    with js.mesh:
        jout = jax.jit(js.run_periods)(js.init_state(), jev, jnows)
    tout = ts.run_periods(ts.init_state(), tev, tnows)
    assert_state_equal(jout.state, tout.state)
    for k, v in jout.metrics.items():
        np.testing.assert_array_equal(np.asarray(v).astype(np.int64),
                                      tout.metrics[k].numpy(), err_msg=k)
    m = {k: v.numpy() for k, v in tout.metrics.items()}
    assert m["reports_sent"].sum() > 65536
    np.testing.assert_array_equal(m["reports_recv"], m["reports_sent"])
    assert m["seq_anomalies"].sum() == 0
    wrapped = np.cumsum(m["reports_sent"]) > 65536
    assert (m["lost_reports"][~wrapped] == 0).all()
    np.testing.assert_array_equal(m["lost_reports"][wrapped][1:],
                                  (1 << 32) - m["reports_recv"][wrapped][1:])
    assert int(tout.state.collector.last_seq[0]) == 65536
    assert int(tout.state.collector.received) == m["reports_sent"].sum()


def test_wrapped_seqs_in_the_duplicate_window_match_jax():
    """A collector whose window stands at 65,536 (after a wrap) and a
    reporter whose seq comes back below 65,535: reports within
    ``seq_dup_window`` (2048) of 65,535 count as replays, in both
    packages alike."""
    from repro_torch.convert import state_from_numpy
    js, ts = systems("v2")
    T = 8
    jev, jnows, tev, tnows = traces(T=T, E=EVENTS, n_flows=N_FLOWS,
                                    flow_seed=1)
    st = jax.tree.map(np.asarray, js.init_state())
    # 65536 + 62464: the reporter's u32 counter past one wrap, its wire
    # seq 3 periods below the window
    st = st._replace(
        reporter=st.reporter._replace(
            seq=np.full_like(st.reporter.seq, 65536 + 62464)),
        collector=st.collector._replace(
            last_seq=np.where(np.arange(st.collector.last_seq.size) == 0,
                              65536, 0).astype(np.uint32)))
    with js.mesh:
        jout = jax.jit(js.run_periods)(jax.tree.map(jnp.asarray, st),
                                       jev, jnows)
    tout = ts.run_periods(state_from_numpy(st, device="cpu"), tev, tnows)
    assert_state_equal(jout.state, tout.state)
    for k, v in jout.metrics.items():
        np.testing.assert_array_equal(np.asarray(v).astype(np.int64),
                                      tout.metrics[k].numpy(), err_msg=k)
    anom = tout.metrics["seq_anomalies"].numpy()
    assert anom[0] == 0 and anom.sum() >= 2048, anom


DESCRIBE_KEYS = sorted([
    "device", "kernel_backend", "wire_format", "event_tile",
    "ring_region_bytes", "n_shards", "flow_home", "pods", "shards_per_pod",
    "total_ports", "ports_per_device", "reporter_slots",
    "port_report_capacity", "crosspod_exchange", "crosspod_capacity",
    "stage2_capacity", "home_nodes", "overlap_periods",
    "inference_head", "snapshot_every_periods", "snapshot_keep",
    "serve_offered_eps", "serve_budget_us", "serve_queue_events",
    "drop_policy", "fault_injection", "rehome_collision_policy",
    "tuning_registry",
])
TPU_ONLY = ("gather_variant", "ingest_variant", "ingest_vmem_bytes",
            "gather_vmem_bytes", "vmem_budget_bytes")


def test_describe_keys_and_tpu_only_keys_absent():
    cfg = dataclasses.replace(REDUCED_V2_WIDE, serve_offered_eps=1e6,
                              serve_queue_events=512, drop_policy="oldest")
    d = DFASystem(cfg, device="cpu").describe()
    assert sorted(d) == DESCRIBE_KEYS
    assert not set(TPU_ONLY) & set(d)
    assert d["wire_format"] == "v2" and d["device"] == "cpu"
    assert d["serve_offered_eps"] == 1e6 and d["drop_policy"] == "oldest"
    assert d["serve_budget_us"] == cfg.monitoring_period_us
    assert d["fault_injection"] == "none"
    assert d["tuning_registry"] == "none"
    assert d["ring_region_bytes"] == 4096 * 10 * 65
    assert d["event_tile"] == 64
    d2 = DFASystem(dataclasses.replace(REDUCED, serve_budget_us=5_000),
                   device="cpu").describe()
    assert d2["serve_budget_us"] == 5_000 and d2["wire_format"] == "v1"
    # the reference reports the same values under the shared keys
    ref = jax_system(wire_format="v2", **WIDE).describe()
    for k in DESCRIBE_KEYS:
        if k in ("device", "kernel_backend", "ring_region_bytes",
                 "snapshot_keep"):
            continue
        assert ref[k] == DFASystem(REDUCED_V2_WIDE,
                                   device="cpu").describe()[k], k


@pytest.mark.parametrize("R,batch", [(8, 4), (10, 4), (16, 16), (3, 1)])
def test_batch_payloads_matches_jax(R, batch):
    rng = np.random.default_rng(R * 31 + batch)
    pay = rng.integers(0, 1 << 32, (R, 16), dtype=np.uint64).astype(
        np.uint32)
    mask = rng.random(R) < 0.4
    jm, jmask = JT.batch_payloads(jnp.asarray(pay), jnp.asarray(mask), batch)
    tm, tmask = TT.batch_payloads(torch.from_numpy(pay.view(np.int32)),
                                  torch.from_numpy(mask), batch)
    np.testing.assert_array_equal(np.asarray(jm).view(np.int32), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    assert tm.shape == (R // batch, batch * 16)
