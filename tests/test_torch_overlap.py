"""The port's overlapped driver: ``run_periods_overlapped`` equals
``run_periods`` bit for bit, and equals the reference's
``run_periods_overlapped``.

On REDUCED shapes with ``device="cpu"``: features, flow ids, masks,
every metric, preds and the whole end state; the T = 1 degenerate case
(warm-up + drain only); the inference head; ``stream``'s dispatch on
``cfg.overlap_periods``; and ``dfa_step`` as the composition of its two
halves.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED, REDUCED_INFER, REDUCED_OVERLAP
from repro_torch.convert import state_to_numpy
from repro_torch.core.pipeline import DFASystem
from test_torch_pipeline import (assert_outputs_equal, assert_state_equal,
                                 jax_system, traces)


def assert_streams_equal(a, b):
    """Two port runs: everything bit for bit."""
    assert torch.equal(a.enriched, b.enriched)
    assert torch.equal(a.flow_ids, b.flow_ids)
    assert torch.equal(a.mask, b.mask)
    assert sorted(a.metrics) == sorted(b.metrics)
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k]), k
    for x, y in zip(state_to_numpy(a.state), state_to_numpy(b.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert (a.preds is None) == (b.preds is None)
    if a.preds is not None:
        assert torch.equal(a.preds, b.preds)


@pytest.mark.parametrize("T,n_flows", [(5, 12), (3, 200)])
def test_overlapped_equals_sequential(T, n_flows):
    ts = DFASystem(REDUCED, device="cpu")
    _, _, tev, tnows = traces(T=T, n_flows=n_flows, flow_seed=7)
    seq = ts.run_periods(ts.init_state(), tev, tnows)
    ovl = ts.run_periods_overlapped(ts.init_state(), tev, tnows)
    assert_streams_equal(seq, ovl)
    assert ovl.enriched.shape[0] == T


def test_overlapped_matches_jax_overlapped():
    js = jax_system(overlap_periods=True)
    ts = DFASystem(REDUCED_OVERLAP, device="cpu")
    jev, jnows, tev, tnows = traces(T=4)
    with js.mesh:
        jout = jax.jit(js.run_periods_overlapped)(js.init_state(), jev,
                                                  jnows)
    tout = ts.stream(ts.init_state(), tev, tnows)    # cfg: overlapped
    assert_state_equal(jout.state, tout.state)
    assert_outputs_equal(jout, tout)


def test_overlapped_t1_degenerate():
    ts = DFASystem(REDUCED, device="cpu")
    _, _, tev, tnows = traces(T=1)
    seq = ts.run_periods(ts.init_state(), tev, tnows)
    ovl = ts.stream(ts.init_state(), tev, tnows, overlapped=True)
    assert_streams_equal(seq, ovl)
    assert ovl.enriched.shape[0] == 1


def test_overlapped_with_inference_head():
    ts = DFASystem(REDUCED_INFER, device="cpu")
    _, _, tev, tnows = traces(T=4, n_flows=40)
    seq = ts.stream(ts.init_state(), tev, tnows, overlapped=False)
    ovl = ts.stream(ts.init_state(), tev, tnows)
    assert ovl.preds is not None
    assert ovl.preds.shape == (4, REDUCED.report_capacity,
                               REDUCED_INFER.inference_classes)
    assert_streams_equal(seq, ovl)


def test_dfa_step_is_half_step_composition():
    ts = DFASystem(dataclasses.replace(REDUCED, inference_head="mlp"),
                   device="cpu")
    _, _, tev, tnows = traces(T=2, n_flows=30)
    # two states: the ring is written in place
    s1, s2 = ts.init_state(), ts.init_state()
    for t in range(2):
        ev = {k: v[t] for k, v in tev.items()}
        step = ts.dfa_step(s1, ev, tnows[t])
        s2, routed, metrics = ts.ingest_half(s2, ev, tnows[t])
        enriched, flow_ids, mask, preds = ts.enrich_half(s2, routed)
        assert torch.equal(step.enriched, enriched)
        assert torch.equal(step.flow_ids, flow_ids)
        assert torch.equal(step.mask, mask)
        assert torch.equal(step.preds, preds)
        for k in metrics:
            assert torch.equal(step.metrics[k], metrics[k]), k
        s1 = step.state
    for x, y in zip(state_to_numpy(s1), state_to_numpy(s2)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
