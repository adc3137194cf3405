"""The feature derivation's corners: the port's plain versions against JAX.

``tests/test_torch_cuda.py`` holds the CUDA gather_enrich (K3) and
derived_features (K5) kernels against their plain versions on the card at
the corner inputs of ``tests/torch_corners.py``. These tests tie those
plain versions to the reference at the same inputs, built from the same
numpy seeds: ``derive_ref`` against ``derived_features_pallas``
(interpret) and ``repro.core.enrich.derive_ref``, ``gather_enrich_ref``
against the reference's ``gather_enrich_ref``, all by the row-scaled 1e-5
rule of ``tests/test_gather_enrich_equiv.py``. Shapes: H in {1, 10, 16,
17, 33}, D in {40, 96, 128}, both wire formats. Also checks that the
corner rows select the newest entry they are meant to exercise, and the
wrappers' refusals, which run before any launch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.core import enrich as JE
from repro.core import wire as JWIRE
from repro.kernels.derived_features.kernel import derived_features_pallas
from repro.kernels.gather_enrich.ref import gather_enrich_ref as j_gather_ref
from repro_torch import u32 as U
from repro_torch.configs import REDUCED
from repro_torch.core import enrich as TE
from repro_torch.core import wire as WIRE
from repro_torch.kernels.derived_features import kernel as DK
from repro_torch.kernels.gather_enrich import kernel as GK
from repro_torch.kernels.gather_enrich import ref as GR
from test_gather_enrich_equiv import assert_feature_close
from torch_corners import KINDS, corner_ids, corner_ring

JCFG = get_dfa_config(reduced=True)
ROWS = 4 * KINDS
HISTORIES = [1, 10, 16, 17, 33]


def configs(H, D, wire):
    return (dataclasses.replace(JCFG, history=H, derived_dim=D,
                                wire_format=wire),
            dataclasses.replace(REDUCED, history=H, derived_dim=D,
                                wire_format=wire))


@pytest.mark.parametrize("D", [40, 96, 128])
@pytest.mark.parametrize("H", HISTORIES)
@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_derive_ref_corners_match_jax(H, D, wire):
    jcfg, tcfg = configs(H, D, wire)
    mem, valid = corner_ring(np.random.default_rng(H * 1000 + D), ROWS, H,
                             wire)
    got = TE.derive_ref(U.from_numpy(mem), torch.from_numpy(valid),
                        tcfg).numpy()
    assert got.shape == (ROWS, D) and np.isfinite(got).all()
    jm, jv = jnp.asarray(mem), jnp.asarray(valid)
    assert_feature_close(got, derived_features_pallas(
        jm, jv, derived_dim=D, flow_tile=ROWS, interpret=True,
        wire=JWIRE.resolve(jcfg)))
    assert_feature_close(got, JE.derive_ref(jm, jv, jcfg))


@pytest.mark.parametrize("H", HISTORIES)
@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_gather_enrich_ref_corners_match_jax(H, wire):
    """Ids below 0 and at or above F (clamped) and duplicate ids."""
    jcfg, tcfg = configs(H, 96, wire)
    rng = np.random.default_rng(H)
    mem, valid = corner_ring(rng, ROWS, H, wire)
    ids = corner_ids(rng, 3 * ROWS, ROWS)
    assert (ids < 0).any() and (ids >= ROWS).any()
    assert len(np.unique(ids)) < len(ids)
    got = GR.gather_enrich_ref(U.from_numpy(mem), torch.from_numpy(valid),
                               torch.from_numpy(ids), tcfg).numpy()
    assert np.isfinite(got).all()
    assert_feature_close(got, j_gather_ref(
        jnp.asarray(mem), jnp.asarray(valid), jnp.asarray(ids, jnp.int32),
        jcfg))


def test_corner_rows_select_what_they_claim():
    """The kinds of ``torch_corners`` reach the selection rules they name:
    the newest entry is the first maximum of ``where(valid, count, 0)``
    compared unsigned, and its features are zero when it is invalid."""
    H = 10
    mem, valid = corner_ring(np.random.default_rng(7), 60, H)
    count = np.where(valid, mem[..., 1], 0).astype(np.uint32)
    newest = count.argmax(-1)
    kind = np.arange(60) % KINDS
    signed = count.view(np.int32).argmax(-1)
    assert (newest[kind == 2] == 0).all() and not valid[kind == 2, 0].any()
    assert (signed != newest)[kind == 3].any()       # unsigned matters
    assert not valid[kind == 4].any()
    ties = [(count[r] == count[r].max()).sum() > 1
            for r in np.flatnonzero((kind == 1) | (kind == 5))]
    assert all(ties)
    assert (~valid[kind == 1, 0]).any() and valid[kind == 1, 0].any()
    cfg = dataclasses.replace(REDUCED, history=H)
    out = TE.derive_ref(U.from_numpy(mem), torch.from_numpy(valid),
                        cfg).numpy()
    assert (out[kind == 2, :18] == 0).all()       # invalid entry 0 won
    assert (out[kind == 4, :72] == 0).all() and (out[kind == 4, 72] == 1).all()


def test_wrappers_refuse_what_the_kernel_cannot_take():
    """K3's and K5's shared argument checks (``gather_enrich.kernel.
    check_ring``) raise before any launch, on any device."""
    v1 = WIRE.resolve(REDUCED)
    ring = torch.zeros(4, 10, 16, dtype=torch.int32)
    GK.check_ring(ring, v1)
    flat = torch.zeros(4 * 10 * 16 + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        GK.check_ring(flat[1:].view(4, 10, 16), v1)     # 4 bytes off
    with pytest.raises(ValueError, match="history"):
        GK.check_ring(torch.zeros(1, GK.MAX_HISTORY + 1, 16,
                                  dtype=torch.int32), v1)
    bad = dataclasses.replace(v1, payload_stats=(2, 9))
    with pytest.raises(ValueError, match="wire format"):
        GK.check_ring(ring, bad)
    assert DK.check_ring is GK.check_ring
