"""The port's multi-head latent attention (deepseek-v3's MLA) and its
latent cache against the JAX package on the CPU, at REDUCED width (d 64,
4 heads, q rank 32, kv rank 16, nope 16 + rope 8, v 16), on the (1, 1)
mesh, in f32 to 1e-5 (the same arithmetic summed in another order).

The layer's parameters come from numpy; its norm scales are drawn, not
ones, so that a dropped or misplaced norm shows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.models import attention as TA
from repro_torch.models import lm as LM
from repro_torch.models.param import tree_map_descs
from repro_torch.models.registry import Model
from torch_cross import close

ARCH = "deepseek-v3-671b"
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, port cfg, numpy params of one MLA layer)."""
    jc = jax_config(ARCH, reduced=True).replace(**F32)
    tc = get_config(ARCH, reduced=True).replace(**F32)
    rng = np.random.default_rng(7)
    p = tree_map_descs(
        lambda path, d: (rng.standard_normal(d.shape).astype(np.float32)
                         * (0.1 if path[-1] == "scale" else 0.2)
                         + (1.0 if path[-1] == "scale" else 0.0)),
        TA.mla_descs(tc))
    return jc, tc, p


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_mla_descs_are_the_references(layer):
    jc, tc, _ = layer
    want = jax.tree.map(lambda d: d.shape, JA.mla_descs(jc),
                        is_leaf=lambda n: hasattr(n, "shape"))
    got = tree_map_descs(lambda p, d: d.shape, TA.mla_descs(tc))
    assert got == want


def test_qkv_latent_matches_jax(layer, rng):
    jc, tc, p = layer
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    pos = np.arange(11, dtype=np.float32)
    want = JA._mla_qkv_latent(_j(p), jnp.asarray(x), jc, jnp.asarray(pos))
    got = TA._mla_qkv_latent(_t(p), torch.from_numpy(x), tc,
                             torch.from_numpy(pos))
    assert [tuple(g.shape) for g in got] == [(2, 11, 4, 16), (2, 11, 4, 8),
                                             (2, 11, 16), (2, 11, 8)]
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_mla_train_matches_jax(layer, rng):
    """The expanded prefill path: K6's plain version at D = 24, Dv = 16
    with scale 24^-0.5, against the reference's pure-JAX attention; and
    the latent cache entries it returns."""
    jc, tc, p = layer
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    yj, (cj, kj) = JA.mla_train(_j(p), jnp.asarray(x), jc, return_kv=True)
    FK.KERNEL.reset_counts()
    yt, (ct, kt) = TA.mla_train(_t(p), torch.from_numpy(x), tc,
                                return_kv=True)
    assert FK.KERNEL.launches == 0
    assert yt.shape == (2, 40, 64) and ct.shape == (2, 40, 16)
    for g, w in ((yt, yj), (ct, cj), (kt, kj)):
        close(g, w, 1e-5)


def test_mla_decode_and_latent_cache_match_jax(layer, rng, mesh):
    """The absorbed decode over a partly filled latent cache: one row per
    sequence written at its position (none for a position past the
    cache), the same output, and the caches updated in place."""
    jc, tc, p = layer
    B, S = 3, 20
    pos = np.array([0, 9, 20])            # the last writes nothing
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    ckv = rng.standard_normal((B, S, 16)).astype(np.float32)
    kr = rng.standard_normal((B, S, 8)).astype(np.float32)
    with mesh:
        yj, cj, kj = JA.mla_decode(
            _j(p), jnp.asarray(x), jc, jnp.asarray(ckv), jnp.asarray(kr),
            jnp.asarray(pos, jnp.int32), mesh=mesh, seq_axes=("model",),
            batch_axes=("data",))
    ct, krt = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    yt, c2, k2 = TA.mla_decode(_t(p), torch.from_numpy(x), tc, ct, krt,
                               torch.from_numpy(pos))
    assert c2 is ct and k2 is krt
    close(yt, yj, 1e-5)
    close(ct, cj, 1e-5)
    close(krt, kj, 1e-5)
    np.testing.assert_array_equal(ct[2].numpy(), ckv[2])
    assert not np.array_equal(ct[1, 9].numpy(), ckv[1, 9])


def test_absorbed_decode_equals_the_expanded_forward(layer, rng):
    """The absorbed decode at position P over the prefill's latent cache
    gives the expanded path's output at P over P + 1 tokens."""
    _, tc, p = layer
    P = 13
    x = torch.from_numpy(rng.standard_normal((2, P + 1, 64))
                         .astype(np.float32))
    full = TA.mla_train(_t(p), x, tc)
    _, (c, k) = TA.mla_train(_t(p), x[:, :P], tc, return_kv=True)
    cache = torch.zeros(2, P + 4, 16)
    kr = torch.zeros(2, P + 4, 8)
    cache[:, :P], kr[:, :P] = c, k
    y, _, _ = TA.mla_decode(_t(p), x[:, P:], tc, cache, kr,
                            torch.full((2,), P))
    close(y[:, 0], full[:, P], 1e-5)


def test_latent_cache_descs_and_model_consistency(mesh):
    """deepseek-v3 with every layer dense (MLA + FFN): the cache is the
    latent {ckv (B, S, R), kr (B, S, rope)} per layer, and decode at P
    equals a full forward over P + 1 tokens (with MoE layers decode's C =
    1 drops pairs a forward keeps, in the reference too)."""
    cfg = get_config(ARCH, reduced=True).replace(**F32, mtp_depth=0)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, first_moe_layer=4))
    assert LM._segments(cfg) == [("dense", 4), ("moe", 0)]
    descs = LM.cache_descs(cfg, 2, 30)
    assert len(descs) == 4 and {n: d.shape for n, d in descs[0].items()} == {
        "ckv": (2, 30, 16), "kr": (2, 30, 8)}
    model = Model(cfg, device="cpu")
    params = model.init(3)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 13)))
    P = 12
    _, pc = model.prefill(params, {"tokens": toks[:, :P]})
    cache = TS.build_cache(model, pc, 2, 30)
    dl, _ = model.decode(params, toks[:, P:], torch.full((2,), P), cache)
    h = LM.lm_hidden(params, {"tokens": toks}, cfg)
    full = h[:, -1] @ params["embed"]["unembed"]
    close(dl, full, 1e-5)
