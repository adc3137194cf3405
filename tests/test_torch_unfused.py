"""The port's unfused path against the JAX reference.

The paper's pre-fusion, staged shape of one period: multipass reporter
ingest whose accumulator is the flow_moments family, placement through a
staging copy (``collector.staged_ingest``), and the explicit history
gather (``collector.gather_flow_history``) followed by the standalone
derived_features family.

* ``flow_moments`` — the plain version of the CUDA kernel against
  ``flow_moments_pallas(interpret=True)`` and ``flow_moments_ref``, bit
  for bit, on the sweep shapes of ``tests/test_kernels.py``, a
  wrap-around block and an all-invalid block;
* multipass ingest — ``reporter.ingest(accumulate_fn=flow_moments)``
  against the reference's multipass ingest with its Pallas accumulator
  (interpret) and against the port's fused path, bit for bit on all five
  reporter fields, over the corners of ``tests/test_torch_reporter.py``;
* ``derived_features`` — the plain version against
  ``derived_features_pallas(interpret=True)`` and ``derive_ref`` under
  both wire formats, D in {74, 96, 128}, an all-invalid history and an
  N no Pallas tile divides, by the row-scaled 1e-5 rule;
* collector — ``staged_ingest`` equals ``ingest`` and the reference's
  ``staged_ingest``; ``gather_flow_history`` equals the reference's;
* the slice — ``chip_smoke.unfused_step`` at REDUCED, T = 4, on the
  golden's traffic, against the same composition in JAX, the port's own
  ``run_periods`` and ``tests/goldens/run_periods_t4.json``.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.core import collector as JC
from repro.core import enrich as JE
from repro.core import pipeline as JP
from repro.core import reporter as JR
from repro.core import wire as JWIRE
from repro.kernels.derived_features import ops as JDF
from repro.kernels.derived_features.kernel import derived_features_pallas
from repro.kernels.flow_moments import ops as JFM
from repro.kernels.flow_moments.kernel import (EVENT_BLOCK,
                                               flow_moments_pallas)
from repro.kernels.flow_moments.ref import flow_moments_ref
from repro_torch import u32 as U
from repro_torch.configs import REDUCED
from repro_torch.convert import state_to_numpy
from repro_torch.core import collector as TC
from repro_torch.core import reporter as TR
from repro_torch.core.pipeline import METRIC_KEYS, DFASystem
from repro_torch.kernels.derived_features import ops as DF
from repro_torch.kernels.flow_moments import ops as FM
from test_gather_enrich_equiv import assert_feature_close, make_case
from test_run_periods_golden import GOLDEN_DIR, _assert_matches, _fingerprint
from test_torch_collector import payload_batch
from test_torch_leaves import T, assert_same, rand_u32
from test_torch_pipeline import (assert_outputs_equal, assert_state_equal,
                                 jax_system, traces)
from test_torch_reporter import CORNERS, OUT, make_corner, port_state

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
from chip_smoke import unfused_step  # noqa: E402

JCFG = get_dfa_config(reduced=True)
T_PERIODS = 4


# -- flow_moments ---------------------------------------------------------------

def moments_case(rng, case, F=64, E=EVENT_BLOCK):
    """(regs, slots, deltas, valid) as numpy u32 / int32 / bool."""
    if case == "wrap_around":               # registers just below 2^32
        return (np.full((F, 7), 0xFFFFFF00, np.uint32), np.zeros(E, np.int32),
                np.full((E, 7), 0x10, np.uint32), np.ones(E, bool))
    regs = rng.integers(0, 100, size=(F, 7)).astype(np.uint32)
    return (regs, np.zeros(32, np.int32), np.ones((32, 7), np.uint32),
            np.zeros(32, bool))


def port_moments(regs, slots, deltas, valid, **kw):
    return FM.flow_moments(T(regs), torch.from_numpy(slots.astype(np.int64)),
                           T(deltas), T(valid), **kw)


@pytest.mark.parametrize("F,E,tile", [
    (64, 16, 16), (128, 100, 32), (256, 256, 64), (256, 300, 128),
    (512, 1000, 512),
])
def test_flow_moments_plain_matches_pallas_sweep(rng, F, E, tile):
    regs = rand_u32(rng, (F, 7))
    slots = rng.integers(0, F, size=E).astype(np.int32)
    deltas = rand_u32(rng, (E, 7))
    valid = rng.random(E) > 0.15
    want = flow_moments_pallas(regs, slots, deltas, valid, flow_tile=tile,
                               interpret=True)
    got = port_moments(regs, slots, deltas, valid)
    assert got.dtype == torch.int32 and tuple(got.shape) == (F, 7)
    assert_same(want, got)
    j = lambda a: jnp.asarray(a)           # noqa: E731
    assert_same(flow_moments_ref(j(regs), j(slots), j(deltas), j(valid)), got)
    # widened int64 deltas give the same registers (the oracle widens)
    assert torch.equal(got, FM.flow_moments(
        T(regs), torch.from_numpy(slots.astype(np.int64)),
        U.wide(T(deltas)), T(valid)))


@pytest.mark.parametrize("case", ["wrap_around", "all_invalid"])
def test_flow_moments_wrap_and_all_invalid(rng, case):
    regs, slots, deltas, valid = moments_case(rng, case)
    want = flow_moments_pallas(regs, slots, deltas, valid, flow_tile=64,
                               interpret=True)
    got = port_moments(regs, slots, deltas, valid)
    assert_same(want, got)
    if case == "wrap_around":              # 0xFFFFFF00 + 256 * 0x10
        assert (U.to_numpy(got[0]) == 0xF00).all()
    else:
        assert_same(regs, got)


def test_flow_moments_drops_out_of_range_slots():
    """Slots outside [0, F) are dropped, as the Pallas kernel drops
    them; backend names of the TPU raise."""
    regs = np.zeros((8, 7), np.uint32)
    slots = np.array([0, 8, 100, 3], np.int32)
    got = port_moments(regs, slots, np.ones((4, 7), np.uint32),
                       np.ones(4, bool))
    assert U.to_numpy(got).sum(0).tolist() == [2] * 7
    with pytest.raises(ValueError, match="TPU backend"):
        port_moments(regs, slots, np.ones((4, 7), np.uint32),
                     np.ones(4, bool), backend="pallas")


# -- multipass ingest -----------------------------------------------------------

def jax_accumulate(regs, slots, deltas, valid):
    return JFM.flow_moments(regs, slots, deltas, valid, force="interpret")


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_multipass_ingest_matches_jax_and_fused(rng, name):
    """Port multipass (flow_moments accumulator) == JAX multipass with
    its Pallas accumulator (interpret) == the port's fused path."""
    jcfg, tcfg, st, ev = make_corner(rng, name)
    want = jax.jit(lambda s, e: JR.ingest(
        s, e, jcfg, accumulate_fn=jax_accumulate))(st, ev)
    tev = {k: T(v) for k, v in ev.items()}
    got = TR.ingest(port_state(st), tev, tcfg, accumulate_fn=FM.flow_moments)
    fused = TR.ingest(port_state(st), tev, tcfg)
    for f in OUT:
        assert_same(getattr(want, f), getattr(got, f), f"jax: {f}")
        assert torch.equal(getattr(got, f), getattr(fused, f)), f
    assert got.regs.dtype == torch.int32


def test_admit_state_wrapper_matches_jax(rng):
    jcfg, tcfg, st, ev = make_corner(rng, "occupied_collisions")
    want, wvalid = jax.jit(lambda s, e: JR.admit(
        s, JR.hash_slot(e["five_tuple"], jcfg.flows_per_shard),
        e["five_tuple"], e["valid"]))(st, ev)
    got, gvalid = TR.admit(port_state(st), TR.hash_slot(
        T(ev["five_tuple"]), tcfg.flows_per_shard), T(ev["five_tuple"]),
        T(ev["valid"]))
    for f in ("keys", "active", "collisions", "regs", "last_ts"):
        assert_same(getattr(want, f), getattr(got, f), f)
    assert_same(wvalid, gvalid)


# -- derived_features -------------------------------------------------------------

@pytest.mark.parametrize("derived_dim", [74, 96, 128])
@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_derived_features_plain_matches_pallas(rng, wire, derived_dim):
    jcfg = dataclasses.replace(JCFG, derived_dim=derived_dim,
                               wire_format=wire)
    tcfg = dataclasses.replace(REDUCED, derived_dim=derived_dim,
                               wire_format=wire)
    mem, ev, _ = make_case(rng, 128, JCFG.history, 1)
    got = DF.derived_features(T(mem), T(ev), tcfg).numpy()
    assert got.shape == (128, derived_dim) and np.isfinite(got).all()
    want = derived_features_pallas(mem, ev, derived_dim=derived_dim,
                                   flow_tile=64, interpret=True,
                                   wire=JWIRE.resolve(jcfg))
    assert_feature_close(got, want)
    assert_feature_close(got, JE.derive_ref(mem, ev, jcfg))


@pytest.mark.parametrize("case", ["all_invalid", "N37"])
def test_derived_features_edges(rng, case):
    """An all-invalid history (zero window, nvalid clamped to 1) and an
    N that no Pallas tile divides (the port has no tile)."""
    N = 37 if case == "N37" else 64
    mem, ev, _ = make_case(rng, N, JCFG.history, 1)
    if case == "all_invalid":
        ev = jnp.zeros_like(ev)
    got = DF.derived_features(T(mem), T(ev), REDUCED).numpy()
    assert np.isfinite(got).all()
    assert_feature_close(got, jax.jit(lambda m, v: JDF.derived_features(
        m, v, JCFG, backend="ref"))(mem, ev))
    if case == "all_invalid":
        assert_feature_close(got, derived_features_pallas(
            mem, ev, derived_dim=96, flow_tile=64, interpret=True))
        assert (got[:, :72] == 0).all() and (got[:, 72] == 1).all()


# -- collector ----------------------------------------------------------------------

def test_staged_ingest_matches_ingest_and_jax(rng):
    F = REDUCED.flows_per_shard
    R = 48
    flows = rng.integers(0, F, R).astype(np.uint32)
    seqs = (np.arange(10, 10 + R) + (np.arange(R) >= 20) * 3) % 256
    pays = payload_batch(rng, R, flows, seqs)
    pays[11, 4] ^= 0x40                        # corrupted in flight
    mask = rng.random(R) < 0.9
    want = jax.jit(lambda st, p, m: JC.staged_ingest(st, p, m, 0, JCFG))(
        JC.init_state(JCFG), jnp.asarray(pays), jnp.asarray(mask))
    tp = T(pays)
    got = TC.staged_ingest(TC.init_state(REDUCED), tp, T(mask), 0, REDUCED)
    direct = TC.ingest(TC.init_state(REDUCED), tp, T(mask), 0, REDUCED)
    for f in TC.CollectorState._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
        assert torch.equal(getattr(got, f), getattr(direct, f)), f
    assert torch.equal(tp, T(pays))            # the caller's rows untouched
    assert int(got.bad_checksum) == 1 and int(got.received) > 0


def test_gather_flow_history_matches_jax(rng):
    """Out-of-range ids clamp to F - 1 as the reference's gather clamps
    them (the translator never emits a negative id)."""
    F, H = REDUCED.flows_per_shard, REDUCED.history
    mem, ev = rand_u32(rng, (F, H, 16)), rng.random((F, H)) < 0.5
    lf = np.concatenate([rng.integers(0, F, 60), [F - 1, F, F + 100, 0]]
                        ).astype(np.int32)
    jst = JC.init_state(JCFG)._replace(memory=jnp.asarray(mem),
                                       entry_valid=jnp.asarray(ev))
    tst = TC.init_state(REDUCED)._replace(memory=T(mem), entry_valid=T(ev))
    we, wv = JC.gather_flow_history(jst, jnp.asarray(lf))
    ge, gv = TC.gather_flow_history(tst, torch.from_numpy(lf))
    assert tuple(ge.shape) == (64, H, 16) and tuple(gv.shape) == (64, H)
    assert_same(we, ge)
    assert_same(wv, gv)


# -- the slice ------------------------------------------------------------------------

class _Substituted:
    """A module with some of its functions replaced (the rest pass
    through)."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jax_unfused_enrich(coll_st, local_flow, cfg, mask=None):
    entries, valid = JC.gather_flow_history(coll_st, local_flow)
    feats = JDF.derived_features(entries, valid, cfg, backend="interpret")
    return jnp.where(mask[:, None], feats, 0.0)


def jax_unfused_run(monkeypatch, jev, jnows):
    """The reference's own pipeline with the same three substitutions:
    multipass ingest through its flow_moments kernel (interpret), staged
    placement, history gather + its derived_features kernel
    (interpret)."""
    monkeypatch.setattr(JP, "REP", _Substituted(
        JR, ingest=lambda st, ev, cfg: JR.ingest(
            st, ev, cfg, accumulate_fn=jax_accumulate)))
    monkeypatch.setattr(JP, "COLL", _Substituted(
        JC, ingest=JC.staged_ingest,
        enrich_flow_history=_jax_unfused_enrich))
    js = jax_system()
    with js.mesh:
        return jax.jit(js.run_periods)(js.init_state(), jev, jnows)


def port_unfused_run(system, tev, tnows):
    """``unfused_step`` over T periods, stacked like ``run_periods``."""
    state, outs = system.init_state(), []
    for t in range(len(tnows)):
        out = unfused_step(system, state, {k: v[t] for k, v in tev.items()},
                           tnows[t])
        state = out.state
        outs.append(out)
    stack = lambda f: torch.stack([getattr(o, f) for o in outs])  # noqa
    return outs[-1]._replace(
        enriched=stack("enriched"), flow_ids=stack("flow_ids"),
        mask=stack("mask"),
        metrics={k: torch.stack([o.metrics[k] for o in outs])
                 for k in METRIC_KEYS},
        preds=None if outs[0].preds is None else stack("preds"))


def test_unfused_step_matches_jax_composition_and_golden(monkeypatch):
    """REDUCED, T = 4, the golden's traffic: the port's unfused path ==
    the reference's unfused composition (state bitwise, metrics exact,
    features row-scaled) == the port's fused run_periods, and it
    reproduces run_periods_t4.json."""
    jev, jnows, tev, tnows = traces()
    system = DFASystem(REDUCED, device="cpu")
    got = port_unfused_run(system, tev, tnows)
    jout = jax_unfused_run(monkeypatch, jev, jnows)
    assert_state_equal(jout.state, got.state)
    assert_outputs_equal(jout, got)
    fused = system.run_periods(system.init_state(), tev, tnows)
    for x, y in zip(state_to_numpy(got.state), state_to_numpy(fused.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for k in METRIC_KEYS:
        assert torch.equal(got.metrics[k], fused.metrics[k]), k
    assert torch.equal(got.flow_ids, fused.flow_ids)
    for g, w in zip(got.enriched.numpy(), fused.enriched.numpy()):
        assert_feature_close(g, w)
    with open(os.path.join(GOLDEN_DIR, "run_periods_t4.json")) as f:
        want = json.load(f)
    _assert_matches(_fingerprint(
        state_to_numpy(got.state), got.enriched.numpy(),
        got.flow_ids.numpy(), got.mask.numpy(),
        {k: v.numpy() for k, v in got.metrics.items()}), want)


def test_unfused_step_with_head_and_collisions():
    """200 flows over 256 slots (collisions) with the mlp head: period by
    period the unfused step equals the fused dfa_step."""
    system = DFASystem(dataclasses.replace(REDUCED, inference_head="mlp"),
                       device="cpu")
    _, _, tev, tnows = traces(n_flows=200, flow_seed=1)
    su, sf = system.init_state(), system.init_state()
    for t in range(T_PERIODS):
        ev = {k: v[t] for k, v in tev.items()}
        u = unfused_step(system, su, ev, tnows[t])
        f = system.dfa_step(sf, ev, tnows[t])
        su, sf = u.state, f.state
        for x, y in zip(state_to_numpy(su), state_to_numpy(sf)):
            for name in type(x)._fields:
                np.testing.assert_array_equal(getattr(x, name),
                                              getattr(y, name))
        for k in METRIC_KEYS:
            assert int(u.metrics[k]) == int(f.metrics[k]), k
        assert_feature_close(u.enriched.numpy(), f.enriched.numpy())
        np.testing.assert_allclose(u.preds.numpy(), f.preds.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert int(sf.reporter.collisions) > 0
