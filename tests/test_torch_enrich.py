"""The port's enrichment and gather_enrich family against JAX.

The plain version of the CUDA gather_enrich kernel is held against the
reference's two Pallas variants (``gather_enrich_pallas`` and
``gather_enrich_hbm_pallas``, interpret mode) and its ``derive_ref``
oracle, with the row-scaled 1e-5 rule of
``tests/test_gather_enrich_equiv.py`` (elementwise rtol is the wrong
yardstick for the cancellation-prone skew and delta columns). Covers
duplicate flow ids, all-invalid rings, non-power-of-2 R, out-of-range
ids (clamped) and the F = 2^17, H = 8 shape.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.core import enrich as JE
from repro.kernels.gather_enrich.kernel import (gather_enrich_hbm_pallas,
                                                gather_enrich_pallas)
from repro.kernels.gather_enrich.ops import gather_enrich as j_gather
from repro_torch.configs import REDUCED
from repro_torch.core import enrich as TE
from repro_torch.kernels.gather_enrich import ops as GE
from test_gather_enrich_equiv import assert_feature_close, make_case
from test_torch_leaves import T

JCFG = get_dfa_config(reduced=True)


def port(mem, ev, lf, cfg=REDUCED):
    return GE.gather_enrich(T(mem), T(ev), torch.from_numpy(
        np.asarray(lf, np.int64)), cfg).numpy()


@pytest.mark.parametrize("case", ["dup_ids", "all_invalid", "R100",
                                  "out_of_range"])
def test_gather_enrich_plain_matches_both_pallas_variants(rng, case):
    F, H = JCFG.flows_per_shard, JCFG.history
    R = {"R100": 100, "out_of_range": 65}.get(case, 64)
    mem, ev, lf = make_case(rng, F, H, R)
    if case == "dup_ids":
        lf = jnp.asarray(np.asarray([3, 3, 3, 17, 3, 17, 250, 3] * 8,
                                    np.int32))
    if case == "all_invalid":
        ev = jnp.zeros((F, H), bool)
    if case == "out_of_range":
        lf = jnp.asarray(np.asarray([-5, 0, F - 1, F + 100, 42] * 13,
                                    np.int32))
    got = port(mem, ev, lf)
    assert got.shape == (R, REDUCED.derived_dim)
    assert np.isfinite(got).all()
    Rp = -(-R // 64) * 64                     # the Pallas kernels tile R
    lfp = jnp.concatenate([lf, jnp.zeros(Rp - R, jnp.int32)])
    for kfn in (gather_enrich_pallas, gather_enrich_hbm_pallas):
        want = kfn(mem, ev, lfp, derived_dim=96, report_tile=64,
                   interpret=True)[:R]
        assert_feature_close(got, want)
    assert_feature_close(got, j_gather(mem, ev, lf, JCFG, backend="ref"))
    if case == "dup_ids":
        rows3 = got[np.asarray(lf) == 3]
        np.testing.assert_array_equal(rows3, np.broadcast_to(rows3[0],
                                                             rows3.shape))


def test_paper_scale_f17_h8(rng):
    """F = 2^17 flows, H = 8: the plain version against the reference's
    HBM-resident kernel (interpret) and its oracle."""
    jcfg = dataclasses.replace(get_dfa_config(), history=8)
    tcfg = dataclasses.replace(REDUCED, flows_per_shard=1 << 17, history=8)
    mem, ev, lf = make_case(rng, 1 << 17, 8, 128)
    got = port(mem, ev, lf, tcfg)
    assert_feature_close(got, gather_enrich_hbm_pallas(
        mem, ev, lf, derived_dim=96, report_tile=128, interpret=True))
    assert_feature_close(got, j_gather(mem, ev, lf, jcfg, backend="ref"))


@pytest.mark.parametrize("derived_dim", [8, 74, 96, 128])
def test_derive_ref_matches(rng, derived_dim):
    jcfg = dataclasses.replace(JCFG, derived_dim=derived_dim)
    tcfg = dataclasses.replace(REDUCED, derived_dim=derived_dim)
    mem, ev, _ = make_case(rng, 32, 10, 1)
    got = TE.derive_ref(T(mem), T(ev), tcfg).numpy()
    assert got.shape == (32, derived_dim)
    assert_feature_close(got, JE.derive_ref(mem, ev, jcfg))


def test_entry_features_and_masked_enrich(rng):
    stats = rng.integers(0, 1 << 20, (50, 7)).astype(np.uint32)
    assert_feature_close(TE.entry_features(T(stats)).numpy(),
                         JE.entry_features(jnp.asarray(stats)))
    mem, ev, lf = make_case(rng, 256, 10, 40)
    mask = rng.random(40) < 0.5
    want = JE.enrich_history(mem, ev, lf, JCFG, mask=jnp.asarray(mask),
                             backend="ref")
    got = TE.enrich_history(T(mem), T(ev), torch.from_numpy(
        np.asarray(lf, np.int64)), REDUCED, mask=T(mask)).numpy()
    assert (got[~mask] == 0).all()
    assert_feature_close(got, want)
