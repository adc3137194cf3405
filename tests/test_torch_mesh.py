"""The port's 1-D shard mesh against the JAX reference.

``DFASystem(cfg, device="cpu", n_shards=n)`` emulates the reference's
n-device mesh in one process (``flow_home="ingest"``: every flow homed
on its ingest shard, reports bucketed by home shard and exchanged all to
all). On REDUCED shapes, n = 2 against the reference on a (1, 2) pod
mesh and n = 4 against the legacy (2, 2) ("data", "model") mesh: the
port's two drivers (``run_periods``, ``run_periods_overlapped``) match
the reference's jitted ``dfa_step`` period by period — every metric bit
for bit, the fault ledger included, routed flow ids and masks exactly,
features by the row-scaled 1e-5 rule against the reference's enrichment
oracle run op by op on that period's ring (the jitted step rounds the
cancellation-prone skew columns differently, ROADMAP §3), preds to 1e-5
— and the final state leaf by leaf. Once with an armed ``FaultSpec``
(the reference's own draws fed to the port's ``apply``), once with the
linear head and the reference's parameters. The reference systems and
their jitted steps are built once per module.
"""
import dataclasses
from typing import Dict, List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import pod_mesh_or_skip
from repro.compat import make_mesh
from repro.configs import get_dfa_config
from repro.core.pipeline import DFASystem as JSystem
from repro.data import faults as JF
from repro.data import packets as JPK
from repro.kernels.gather_enrich.ref import gather_enrich_ref
from repro.models.registry import get_flow_head
from repro_torch.configs import REDUCED
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.pipeline import DFASystem
from repro_torch.data import faults as FAULTS
from repro_torch.data import packets as PK
from test_gather_enrich_equiv import assert_feature_close
from test_torch_faults import MIXED, patched_draw

T = 3
EVENTS = 128                 # per shard and period
N_FLOWS = 60


class Period(NamedTuple):
    """One reference period, as numpy."""
    state: object
    metrics: Dict[str, np.ndarray]
    flow_ids: np.ndarray
    mask: np.ndarray
    oracle: np.ndarray           # op-by-op enrichment of the period's ring
    preds: object                # reference head on ``oracle``, or None


def oracle_features(cfg, state, flow_ids, mask, bases, fps):
    """The reference's enrichment oracle run op by op (not fused by XLA)
    over the period's global ring: device d's rows address its slice of
    the stacked rings at d * fps + (flow id - its flow base)."""
    n = len(bases)
    dev = np.repeat(np.arange(n), mask.shape[0] // n)
    lf = np.where(mask, dev * fps + (flow_ids.astype(np.int64)
                                     - np.asarray(bases, np.int64)[dev]), 0)
    with jax.disable_jit():
        feats = gather_enrich_ref(jnp.asarray(state.collector.memory),
                                  jnp.asarray(state.collector.entry_valid),
                                  jnp.asarray(lf.astype(np.int32)), cfg)
    return np.where(mask[:, None], np.asarray(feats), 0.0)


def reference_periods(js, jev, jnows, bases, step=None) -> List[Period]:
    """The reference's jitted ``dfa_step``, period by period."""
    step = step or jax.jit(js.dfa_step)
    head = None
    if js.infer_params is not None:
        _, head = get_flow_head(js.cfg, jax.random.key(0))
    st, out = js.init_state(), []
    with js.mesh:
        for t in range(len(jnows)):
            o = step(st, {k: v[t] for k, v in jev.items()}, jnows[t])
            st = o.state
            state = jax.tree.map(np.asarray, o.state)
            fid, m = np.asarray(o.flow_ids), np.asarray(o.mask)
            feats = oracle_features(js.cfg, state, fid, m, bases,
                                    js.cfg.flows_per_shard)
            preds = None
            if head is not None:
                preds = np.where(m[:, None], np.asarray(
                    head(js.infer_params, feats)), 0.0)
            out.append(Period(state, {k: np.asarray(v) for k, v in
                                      o.metrics.items()}, fid, m, feats,
                              preds))
    return out


def assert_state_equal(want, tstate, msg=""):
    """Reference numpy state vs the port's, leaf by leaf (shape, dtype,
    bits)."""
    got = state_to_numpy(tstate)
    for group in ("reporter", "translator", "collector"):
        w, g = getattr(want, group), getattr(got, group)
        for f in type(g)._fields:
            a, b = getattr(w, f), getattr(g, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (group, f,
                                                               a.shape,
                                                               b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{group}.{f}")


def assert_features_match(got, want):
    """Entries that are not finite (the f32 window moments overflow on
    some traces, in both packages) equal exactly; the finite ones by the
    row-scaled 1e-5 rule."""
    got, want = np.asarray(got), np.asarray(want)
    odd = ~np.isfinite(want)
    np.testing.assert_array_equal(got[odd], want[odd])
    assert_feature_close(np.where(odd, 0.0, got), np.where(odd, 0.0, want))


def assert_stream_matches(ref: List[Period], tout, msg=""):
    """The port's stacked stream against the reference's periods."""
    assert tout.enriched.shape[0] == len(ref)
    for t, p in enumerate(ref):
        assert sorted(p.metrics) == sorted(tout.metrics), t
        for k, v in p.metrics.items():
            np.testing.assert_array_equal(
                v.astype(np.int64), tout.metrics[k][t].numpy(),
                err_msg=f"{msg}period {t} metric {k}")
        np.testing.assert_array_equal(p.flow_ids.astype(np.int64),
                                      tout.flow_ids[t].numpy())
        np.testing.assert_array_equal(p.mask, tout.mask[t].numpy())
        assert_features_match(tout.enriched[t].numpy(), p.oracle)
        if p.preds is not None:
            np.testing.assert_allclose(tout.preds[t].numpy(), p.preds,
                                       rtol=1e-5, atol=1e-5)
    assert_state_equal(ref[-1].state, tout.state, msg)


def to_numpy_events(tev):
    return {k: (v.numpy() if k == "valid" else v.numpy().view(np.uint32))
            for k, v in tev.items()}


# -- the 1-D mesh against the reference ---------------------------------------

def mesh_of(n: int):
    """n = 2: a (1, 2) pod mesh; n = 4: the legacy (2, 2) ("data",
    "model") mesh."""
    if n == 2:
        return pod_mesh_or_skip(1, 2)
    return make_mesh((2, 2), ("data", "model"))


_cases = {}


def case(n: int, extra: str):
    """(reference periods, port system, port events, nows, infer params),
    built once per (n, extra)."""
    key = (n, extra)
    if key not in _cases:
        jkw, tkw = {}, {}
        if extra == "faults":
            jkw = {"fault_spec": JF.FaultSpec(**dataclasses.asdict(MIXED))}
            tkw = {"fault_spec": MIXED}
        else:
            jkw = tkw = {"inference_head": extra}
        js = JSystem(dataclasses.replace(get_dfa_config(reduced=True),
                                         kernel_backend="ref", **jkw),
                     mesh_of(n))
        jev, jnows = JPK.period_batches(n, T, EVENTS, n_flows=N_FLOWS,
                                        flow_seed=n)
        tev, tnows = PK.period_batches(n, T, EVENTS, n_flows=N_FLOWS,
                                       flow_seed=n)
        for k, v in to_numpy_events(tev).items():
            np.testing.assert_array_equal(np.asarray(jev[k]), v)
        ref = reference_periods(js, jev, jnows,
                                [s * REDUCED.flows_per_shard
                                 for s in range(n)])
        params = (None if js.infer_params is None else
                  {k: np.asarray(v) for k, v in js.infer_params.items()})
        ts = DFASystem(dataclasses.replace(REDUCED, **tkw), device="cpu",
                       n_shards=n, infer_params=params)
        _cases[key] = (ref, ts, tev, tnows)
    return _cases[key]


@pytest.mark.parametrize("driver", ["sequential", "overlapped"])
@pytest.mark.parametrize("extra", ["faults", "linear"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh1d_matches_jax(monkeypatch, n, extra, driver):
    ref, ts, tev, tnows = case(n, extra)
    monkeypatch.setattr(FAULTS, "draw", patched_draw("v1"))
    out = ts.stream(ts.init_state(), tev, tnows,
                    overlapped=driver == "overlapped")
    assert_stream_matches(ref, out, f"n={n} {extra} {driver}: ")
    m = {k: v.numpy() for k, v in out.metrics.items()}
    assert m["reports_recv"].sum() > 0
    if extra == "faults":
        # the ledger is shard-major: n shards x 2R rows (copy region)
        assert out.metrics["fault_kind"].shape == (
            T, n * 2 * REDUCED.report_capacity)
        assert m["injected_drops"].sum() > 0
    else:
        assert out.preds.shape == (T, n * REDUCED.report_capacity,
                                   REDUCED.inference_classes)


def test_mesh1d_state_carry_from_jax():
    """The reference's 4-shard state after period 0 crosses over with no
    reshape and the port runs periods 1.. to the reference's end."""
    ref, ts, tev, tnows = case(4, "linear")
    tstate = state_from_numpy(ref[0].state, device="cpu")
    assert_state_equal(ref[0].state, tstate)
    out = ts.run_periods(tstate, {k: v[1:] for k, v in tev.items()},
                         tnows[1:])
    assert_stream_matches(ref[1:], out)


def test_mesh1d_accounting_in_place_ring_and_describe():
    """Every period: sent == received + bucket drops + misroutes (the
    identity chip_smoke.py's [mesh1d] holds on the card); the shards'
    rings are views of one tensor written in place; describe() names the
    mesh."""
    ts = DFASystem(REDUCED, device="cpu", n_shards=4)
    tev, tnows = PK.period_batches(4, T, EVENTS, n_flows=200, flow_seed=5)
    state = ts.init_state()
    ring = state.collector.memory
    assert ring.shape == (4 * REDUCED.flows_per_shard, REDUCED.history, 16)
    assert state.collector.received.shape == (4,)
    assert state.reporter.seq.shape == (4,)
    out = ts.run_periods(state, tev, tnows)
    assert out.state.collector.memory.data_ptr() == ring.data_ptr()
    m = {k: v.numpy() for k, v in out.metrics.items()}
    np.testing.assert_array_equal(
        m["reports_sent"], m["reports_recv"] + m["bucket_drops"]
        + m["misroutes"])
    assert m["bucket_drops"].sum() > 0      # 128 reports into 4 x 32
    d = ts.describe()
    assert d["n_shards"] == 4 and d["total_ports"] == 4
    assert d["pods"] == 1 and d["shards_per_pod"] == 4
    assert d["home_nodes"] == (0, 1, 2, 3)


def test_mesh1d_one_shard_layout():
    """One shard keeps the reference's one-shard layout (scalar counters
    as (1,) vectors) and every metric stays one scalar per period, which
    is what the serving loop's per-period record keeps."""
    ts = DFASystem(REDUCED, device="cpu")
    st = ts.init_state()
    assert st.collector.received.shape == (1,)
    assert st.reporter.collisions.shape == (1,)
    tev, tnows = PK.period_batches(1, T, EVENTS, n_flows=N_FLOWS,
                                   flow_seed=1)
    step = ts.dfa_step(st, {k: v[0] for k, v in tev.items()}, tnows[0])
    assert all(v.dim() == 0 for v in step.metrics.values())
    assert step.state.collector.lost_reports.shape == (1,)


def test_mesh1d_indivisible_events_refused():
    ts = DFASystem(REDUCED, device="cpu", n_shards=4)
    tev, tnows = PK.period_batches(4, 1, EVENTS, n_flows=N_FLOWS)
    ev = {k: v[0][:-2] for k, v in tev.items()}
    with pytest.raises(ValueError, match="divide across"):
        ts.dfa_step(ts.init_state(), ev, tnows[0])
