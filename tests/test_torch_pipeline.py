"""The port's single-shard main path against the JAX reference.

On REDUCED shapes with ``device="cpu"`` (every kernel runs its plain
version): the port's monitoring period matches the reference's period
by period — every state leaf bit for bit, all eight metrics exactly,
features by the row-scaled 1e-5 rule, preds to 1e-5 — against
``kernel_backend="ref"`` and, once, ``"interpret"``. The port also
reproduces ``tests/goldens/run_periods_t4.json`` through the golden
test's own fingerprint, carries a reference state across mid-stream,
and refuses what is not ported (the mesh's own tests are
``test_torch_mesh.py`` and ``test_torch_mesh2d.py``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_dfa_config
from repro.core.pipeline import DFASystem as JSystem
from repro.data import packets as JPK
from repro.kernels.gather_enrich.ref import gather_enrich_ref
from repro_torch.configs import REDUCED
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.pipeline import METRIC_KEYS, DFASystem
from repro_torch.data import packets as PK
from test_gather_enrich_equiv import assert_feature_close
from test_run_periods_golden import (EVENTS_PER_SHARD, GOLDEN_DIR,
                                     _assert_matches, _fingerprint)

T_PERIODS = 4


def jax_system(backend="ref", **kw):
    cfg = dataclasses.replace(get_dfa_config(reduced=True),
                              kernel_backend=backend, **kw)
    return JSystem(cfg, make_mesh((1, 1), ("data", "model")))


def traces(T=T_PERIODS, E=EVENTS_PER_SHARD, n_flows=10, flow_seed=3):
    jev, jnows = JPK.period_batches(1, T, E, n_flows=n_flows,
                                    flow_seed=flow_seed)
    tev, tnows = PK.period_batches(1, T, E, n_flows=n_flows,
                                   flow_seed=flow_seed)
    for k in tev:
        np.testing.assert_array_equal(
            np.asarray(jev[k]).view(np.int32) if k != "valid"
            else np.asarray(jev[k]), tev[k].numpy())
    return jev, jnows, tev, tnows


def assert_state_equal(jstate, tstate, msg=""):
    want = jax.tree.map(np.asarray, jstate)
    got = state_to_numpy(tstate)
    for group in ("reporter", "translator", "collector"):
        w, g = getattr(want, group), getattr(got, group)
        for f in type(g)._fields:
            a, b = getattr(w, f), getattr(g, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (group, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{group}.{f}")


def assert_outputs_equal(jout, tout, features=None):
    """Metrics, flow ids and masks exact; features row-scaled against
    ``features`` (default: the reference step's own output)."""
    sel = np.asarray
    for k in METRIC_KEYS:
        np.testing.assert_array_equal(
            sel(jout.metrics[k]).astype(np.int64),
            tout.metrics[k].numpy(), err_msg=f"metric {k}")
    np.testing.assert_array_equal(sel(jout.flow_ids).astype(np.int64),
                                  tout.flow_ids.numpy())
    np.testing.assert_array_equal(sel(jout.mask), tout.mask.numpy())
    want = sel(jout.enriched) if features is None else features
    got = tout.enriched.numpy()
    for w, g in zip(want.reshape(-1, *want.shape[-2:]),
                    got.reshape(-1, *got.shape[-2:])):
        assert_feature_close(g, w)


def eager_reference_features(jout):
    """The reference's enrichment oracle run op by op (not fused by XLA)
    on the period's ring and routed flows."""
    lf = np.where(np.asarray(jout.mask), np.asarray(jout.flow_ids), 0)
    with jax.disable_jit():
        feats = gather_enrich_ref(jout.state.collector.memory,
                                  jout.state.collector.entry_valid,
                                  jnp.asarray(lf.astype(np.int32)),
                                  get_dfa_config(reduced=True))
    return np.where(np.asarray(jout.mask)[:, None], np.asarray(feats), 0.0)


@pytest.mark.parametrize("n_flows,flow_seed", [(10, 3), (200, 1)])
def test_period_by_period_matches_jax_ref(n_flows, flow_seed):
    """dfa_step each period: state leaves bitwise, metrics exact,
    features row-scaled. 200 flows over 256 slots add collisions.

    Features are held against the reference oracle run op by op: the
    jitted reference step rounds the cancellation-prone skew column
    (``s3/n - mean**3``, amplified 1e6x by the EPS floor when the
    variance clamps to 0) differently from op-by-op evaluation — by up
    to 3e-5 of the row scale on the 200-flow trace, so the reference
    disagrees with itself by that much (ROADMAP §3). The port matches
    the op-by-op oracle; on the 10-flow golden trace the jitted output
    is held too."""
    js = jax_system()
    ts = DFASystem(REDUCED, device="cpu")
    jev, jnows, tev, tnows = traces(n_flows=n_flows, flow_seed=flow_seed)
    jstate, tstate = js.init_state(), ts.init_state()
    step = jax.jit(js.dfa_step)
    with js.mesh:
        for t in range(T_PERIODS):
            jout = step(jstate, {k: v[t] for k, v in jev.items()}, jnows[t])
            tout = ts.dfa_step(tstate, {k: v[t] for k, v in tev.items()},
                               tnows[t])
            jstate, tstate = jout.state, tout.state
            assert_state_equal(jstate, tstate, f"period {t}: ")
            assert_outputs_equal(jout, tout,
                                 features=eager_reference_features(jout))
            if n_flows == 10:
                assert_outputs_equal(jout, tout)


def test_run_periods_matches_jax_interpret():
    """The reference's Pallas kernels (interpret) through run_periods."""
    js = jax_system("interpret")
    ts = DFASystem(REDUCED, device="cpu")
    jev, jnows, tev, tnows = traces()
    with js.mesh:
        jout = jax.jit(js.run_periods)(js.init_state(), jev, jnows)
    tout = ts.run_periods(ts.init_state(), tev, tnows)
    assert_state_equal(jout.state, tout.state)
    assert_outputs_equal(jout, tout)


def test_reproduces_run_periods_golden():
    with open(os.path.join(GOLDEN_DIR, "run_periods_t4.json")) as f:
        want = json.load(f)
    ts = DFASystem(REDUCED, device="cpu")
    _, _, tev, tnows = traces()
    out = ts.run_periods(ts.init_state(), tev, tnows)
    metrics = {k: v.numpy() for k, v in out.metrics.items()}
    got = _fingerprint(state_to_numpy(out.state), out.enriched.numpy(),
                       out.flow_ids.numpy(), out.mask.numpy(), metrics)
    _assert_matches(got, want)


@pytest.mark.parametrize("head", ["linear", "mlp"])
def test_inference_heads_with_carried_params(head):
    """The reference head's parameters cross over by
    head_params_from_numpy; per period the port's preds match the
    reference head applied to the reference oracle's features (the
    jitted step's own features move by its fused rounding, see above)."""
    from repro.models.registry import get_flow_head
    js = jax_system(inference_head=head)
    params = {k: np.asarray(v) for k, v in js.infer_params.items()}
    _, apply = get_flow_head(js.cfg, jax.random.key(0))
    ts = DFASystem(dataclasses.replace(REDUCED, inference_head=head),
                   device="cpu", infer_params=params)
    jev, jnows, tev, tnows = traces()
    jstate, tstate = js.init_state(), ts.init_state()
    step = jax.jit(js.dfa_step)
    with js.mesh:
        for t in range(T_PERIODS):
            jout = step(jstate, {k: v[t] for k, v in jev.items()}, jnows[t])
            tout = ts.dfa_step(tstate, {k: v[t] for k, v in tev.items()},
                               tnows[t])
            jstate, tstate = jout.state, tout.state
            assert_outputs_equal(jout, tout)
            assert tout.preds.shape == (REDUCED.report_capacity,
                                        REDUCED.inference_classes)
            feats = eager_reference_features(jout)
            want = np.where(np.asarray(jout.mask)[:, None],
                            np.asarray(apply(js.infer_params, feats)), 0.0)
            np.testing.assert_allclose(tout.preds.numpy(), want,
                                       rtol=1e-5, atol=1e-5)


def test_state_carry_from_jax():
    """JAX runs 2 periods; its state crosses over; both run 2 more."""
    js = jax_system()
    ts = DFASystem(REDUCED, device="cpu")
    jev, jnows, tev, tnows = traces(n_flows=40)
    run = jax.jit(js.run_periods)
    with js.mesh:
        first = run(js.init_state(), {k: v[:2] for k, v in jev.items()},
                    jnows[:2])
        tstate = state_from_numpy(jax.tree.map(np.asarray, first.state),
                                  device="cpu")
        assert_state_equal(first.state, tstate)
        jout = run(first.state, {k: v[2:] for k, v in jev.items()},
                   jnows[2:])
    tout = ts.run_periods(tstate, {k: v[2:] for k, v in tev.items()},
                          tnows[2:])
    assert_state_equal(jout.state, tout.state)
    assert_outputs_equal(jout, tout)


def test_backend_ref_equals_auto_on_cpu():
    """The multipass oracle path and the fused path agree end to end."""
    ts = DFASystem(REDUCED, device="cpu")
    _, _, tev, tnows = traces(n_flows=100)
    a = ts.run_periods(ts.init_state(), tev, tnows)
    b = ts.run_periods(ts.init_state(), tev, tnows, backend="ref")
    for x, y in zip(state_to_numpy(a.state), state_to_numpy(b.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert torch.equal(a.enriched, b.enriched)


@pytest.mark.parametrize("change,exc", [
    ({"flow_home": "hash"}, NotImplementedError),
    ({"flow_home": "rendezvous"}, NotImplementedError),
    ({"kernel_backend": "pallas"}, ValueError),
    ({"kernel_backend": "interpret"}, ValueError),
    ({"kernel_backend": "tpu"}, ValueError),
    ({"kernel_backend": "cuda"}, RuntimeError),
])
def test_refuses_what_is_outside_the_slice(change, exc):
    """The TPU and unknown backends, and ``"cuda"`` off the card, stay
    refused. The two ``flow_home`` cases keep their ids, which name the
    ``NotImplementedError`` they raised while the 2-D mesh (ROADMAP §1
    item 8) was not ported; it is now, so they assert instead that the
    system builds on the CPU and that ``describe()`` reports that home."""
    cfg = dataclasses.replace(REDUCED, **change)
    if "flow_home" in change:
        system = DFASystem(cfg, device="cpu")
        assert system.describe()["flow_home"] == change["flow_home"]
        return
    with pytest.raises(exc):
        DFASystem(cfg, device="cpu")


def test_refuses_shards_faults_and_overlap():
    """Two shards (ROADMAP §1 item 7) and a hash home (item 8), refused
    before they were ported, now build and run one REDUCED period; so do
    an armed fault spec and the overlapped driver."""
    from repro_torch.data.faults import FaultSpec
    _, _, tev, tnows = traces(T=1)
    two = DFASystem(REDUCED, device="cpu", n_shards=2)
    ev2, now2 = PK.period_batches(2, 1, EVENTS_PER_SHARD, n_flows=10,
                                  flow_seed=3)
    out = two.stream(two.init_state(), ev2, now2)
    assert out.enriched.shape == (1, 2 * REDUCED.report_capacity,
                                  REDUCED.derived_dim)
    assert int(out.metrics["reports_recv"][0]) > 0
    hashed = DFASystem(dataclasses.replace(REDUCED, flow_home="hash"),
                       device="cpu")
    out = hashed.stream(hashed.init_state(), tev, tnows)
    assert int(out.metrics["reports_recv"][0]) > 0
    armed = DFASystem(dataclasses.replace(
        REDUCED, fault_spec=FaultSpec(seed=1, drop_rate=0.2)), device="cpu")
    out = armed.stream(armed.init_state(), tev, tnows)
    assert int(out.metrics["injected_drops"][0]) > 0
    ts = DFASystem(REDUCED, device="cpu")
    ovl = ts.stream(ts.init_state(), tev, tnows, overlapped=True)
    seq = ts.stream(ts.init_state(), tev, tnows)
    assert seq.enriched.shape[0] == 1
    assert torch.equal(ovl.enriched, seq.enriched)
