"""A query offset through the port's attention, against the JAX package on
the CPU: under the causal mask query row i sits at position q_offset + i
and keeps keys 0..q_offset + i (keys counting from 0), and the rope
positions of a layer are q_offset + arange(S), as in the reference's
``chunked_attention``, ``attn_train``, ``mla_train`` and ``block_train``.

Inputs are drawn with numpy (the layers' weights with
``torch_cross.numpy_params`` from the reference's descriptors) and handed
to both packages; on the CPU the port runs K6's and K7's plain versions.
Offsets 0, 37, 128 and Sk - 1 (which keeps every key), with Sq = Sk and
Sq < Sk. Tolerances, f32: outputs within 2e-5 (``chunked_attention``:
relative and absolute; the layers: of the output's largest element),
gradients within 1e-4 of each gradient's largest element. The kernels'
offset arithmetic is held here through its host side (the ping-pong
plan's key tiles against a brute-force count of the unmasked tiles, and
the fused K7 design's order of dQ additions); on the card ``chip_smoke.py``
holds every K6 and K7 variant against its plain version at offsets 37 and
128.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import lm as JL
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.models import attention as TA
from repro_torch.models import lm as TL
from test_torch_flash_bwd import (check_fused_order, fused_schedule,
                                  run_fused_blocks)
from torch_cross import leaves, numpy_params, to_np

TOL, GRAD_TOL = 2e-5, 1e-4
B, H = 2, 4
F32 = dict(dtype="float32", param_dtype="float32")


def _offsets(Sk):
    return (0, 37, 128, Sk - 1)


# (Sq, Sk, group, D, Dv, q_offset): Sq = Sk and Sq < Sk, group 1 and 4,
# D = Dv and D != Dv, the four offsets
CASES = [(Sq, Sk, group, D, Dv, off)
         for Sq, Sk in ((160, 160), (40, 160))
         for group in (1, 4)
         for D, Dv in ((16, 16), (24, 16))
         for off in _offsets(Sk)]


@functools.lru_cache(maxsize=None)
def _attention_case(Sq, Sk, group, D, Dv, off):
    """(q, k, v, do) numpy and the reference's jitted forward and
    ``jax.vjp`` of ``chunked_attention`` at query offset ``off`` (q
    chunks of up to 16 rows, kv chunks of up to 32)."""
    rng = np.random.default_rng([Sq, Sk, group, D, Dv, off])
    KH = H // group
    args = (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, Dv)).astype(np.float32),
            rng.standard_normal((B, Sq, H, Dv)).astype(np.float32))
    f = lambda q, k, v: JA.chunked_attention(
        q, k, v, causal=True, q_offset=off, q_chunk=16, kv_chunk=32)

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)
    o, grads = jax.jit(fwd_bwd)(*(jnp.asarray(a) for a in args))
    return args, np.asarray(o), [np.asarray(g) for g in grads]


def _rel_err(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


@pytest.mark.parametrize("Sq,Sk,group,D,Dv,off", CASES)
def test_chunked_attention_offset_matches_jax(Sq, Sk, group, D, Dv, off):
    """The port's ``chunked_attention(q_offset=)`` (K6's plain version)
    against the reference's, f32 within 2e-5."""
    (q, k, v, _), want, _ = _attention_case(Sq, Sk, group, D, Dv, off)
    FK.KERNEL.reset_counts()
    got = TA.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=off)
    assert FK.KERNEL.launches == 0
    assert got.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(to_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Sq,Sk,group,D,Dv,off", CASES)
def test_chunked_attention_offset_grads_match_jax(Sq, Sk, group, D, Dv,
                                                  off):
    """dq, dk, dv of the port's ``chunked_attention(q_offset=)`` (torch
    autograd through ``ops.FlashAttention``: the plain forward with its
    logsumexp, then K7's plain version) against ``jax.vjp`` of the
    reference's (its ``_flash_core_bwd``), each within 1e-4 of its
    largest element."""
    (q, k, v, do), _, want = _attention_case(Sq, Sk, group, D, Dv, off)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = TA.chunked_attention(qt, kt, vt, q_offset=off)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, w) <= GRAD_TOL, (name, _rel_err(g, w))


def test_offset_past_the_keys_is_full_attention():
    """An offset >= Sk - 1 keeps every key: the plain versions' output,
    logsumexp and gradients equal the unmasked ones'."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((8, 40, 16), (4, 60, 16), (4, 60, 16),
                               (8, 40, 16)))
    full = FR.flash_attention_lse_ref(q, k, v, group=2, causal=False)
    for off in (59, 60, 1000):
        got = FR.flash_attention_lse_ref(q, k, v, group=2, q_offset=off)
        for g, w in zip(got, full):
            assert torch.equal(g, w), off
        grads = FR.flash_attention_bwd_ref(q, k, v, *full, do, group=2,
                                           q_offset=off)
        want = FR.flash_attention_bwd_ref(q, k, v, *full, do, group=2,
                                          causal=False)
        for g, w in zip(grads, want):
            assert torch.equal(g, w), off


def test_a_negative_offset_raises():
    """Every entry refuses a negative offset with ValueError: the
    reference would give the first rows no key. The kernel wrappers
    refuse it before they look at the tensors' device."""
    q = torch.zeros(1, 8, 2, 16)
    f = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    calls = [
        lambda: TA.chunked_attention(q, q, q, q_offset=-1),
        lambda: FA.flash_attention(f, f, f, q_offset=-3),
        lambda: FA.flash_attention(f.requires_grad_(True), f, f,
                                   q_offset=-3),
        lambda: FR.flash_attention_ref(f, f, f, q_offset=-1),
        lambda: FR.flash_attention_bwd_ref(f, f, f, f, lse, f, q_offset=-1),
        lambda: FK.flash_attention_cuda(f, f, f, q_offset=-1),
        lambda: BK.flash_attention_bwd_cuda(f, f, f, f, lse, f, q_offset=-1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="q_offset"):
            call()


# ------------------------------------------------------------- layers ------

def _cfgs(arch):
    return (jax_config(arch, reduced=True).replace(**F32),
            get_config(arch, reduced=True).replace(**F32))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# (layer, arch): the reference's function and the port's, and the
# descriptors of their parameters
LAYERS = {
    "attn_train": ("granite-3-2b",
                   lambda c: JA.attn_descs(c),
                   lambda p, x, c, off: JA.attn_train(p, x, c,
                                                      q_offset=off),
                   lambda p, x, c, off: TA.attn_train(p, x, c,
                                                      q_offset=off)),
    "mla_train": ("deepseek-v3-671b",
                  lambda c: JA.mla_descs(c),
                  lambda p, x, c, off: JA.mla_train(p, x, c, q_offset=off),
                  lambda p, x, c, off: TA.mla_train(p, x, c, q_offset=off)),
    "block_train": ("granite-3-2b",
                    lambda c: JL.block_descs(c, "dense"),
                    lambda p, x, c, off: JL.block_train(
                        p, x, c, "dense", None, (), q_offset=off),
                    lambda p, x, c, off: TL.block_train(
                        p, x, c, kind="dense", q_offset=off)),
    "block_train_mla": ("deepseek-v3-671b",
                        lambda c: JL.block_descs(c, "dense"),
                        lambda p, x, c, off: JL.block_train(
                            p, x, c, "dense", None, (), q_offset=off),
                        lambda p, x, c, off: TL.block_train(
                            p, x, c, kind="dense", q_offset=off)),
}
S = 48


@pytest.mark.parametrize("off", _offsets(S))
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_offset_matches_jax(layer, off):
    """``attn_train``, ``mla_train`` and ``block_train`` (granite-3-2b's
    and deepseek-v3's, MLA, REDUCED, f32) over positions off..off+47: the
    output within 2e-5 of its largest element, and the gradients of x and
    of every parameter (a numpy cotangent) within 1e-4 of each one's
    largest element, against the reference's under ``jax.vjp``."""
    arch, descs, jfn, tfn = LAYERS[layer]
    jc, tc = _cfgs(arch)
    params = numpy_params(descs(jc))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)

    def fwd_bwd(p, x_, dy_):
        y, vjp = jax.vjp(lambda p_, x__: jfn(p_, x__, jc, off), p, x_)
        return y, vjp(dy_)
    want, (gp, gx) = jax.jit(fwd_bwd)(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jnp.asarray(dy))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), _torch_tree(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(tp, xt, tc, off)
    assert _rel_err(got, want) <= TOL, _rel_err(got, want)
    tl = leaves(tp)
    grads = torch.autograd.grad(got, [xt] + list(tl.values()),
                                torch.from_numpy(dy))
    assert _rel_err(grads[0], gx) <= GRAD_TOL, ("x", _rel_err(grads[0], gx))
    wl = leaves(gp)
    assert set(wl) == set(tl)
    for path, g in zip(tl, grads[1:]):
        err = _rel_err(g, wl[path])
        assert err <= GRAD_TOL, ("/".join(path), err)


@pytest.mark.parametrize("off", _offsets(S))
@pytest.mark.parametrize("layer", ["attn_train", "mla_train"])
def test_layer_offset_rotates_the_cache_entries(layer, off):
    """The keys ``attn_train`` and ``mla_train`` return for the cache
    (``return_kv``: k and v; the latent c_kv and k_rope) are rotated at
    positions off..off+47, as the reference's: within the output's
    tolerance of their largest element. (Inside attention the shift
    cancels: rope makes q . k depend on the positions' difference.)"""
    arch, descs, _, _ = LAYERS[layer]
    jc, tc = _cfgs(arch)
    params = numpy_params(descs(jc))
    x = np.random.default_rng(5).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    jfn, tfn = (JA.attn_train, TA.attn_train) if layer == "attn_train" \
        else (JA.mla_train, TA.mla_train)
    _, want = jax.jit(lambda p, x_: jfn(p, x_, jc, q_offset=off,
                                        return_kv=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    _, got = tfn(_torch_tree(params), torch.from_numpy(x), tc, q_offset=off,
                 return_kv=True)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TOL, _rel_err(g, w)


# ------------------------------------------------ the kernels' host side ----

def _kept_offset(q0, Sq, Sk, tile, off):
    """Key tiles of the item at q0 with a (row < Sq, key < Sk) pair that
    key <= off + row keeps, by brute force over the pairs."""
    rows = np.arange(q0, min(q0 + tile, Sq)) + off
    return {kt for kt in range(-(-Sk // tile))
            if (np.arange(kt * tile, min((kt + 1) * tile, Sk))[:, None]
                <= rows[None, :]).any()}


PLAN_SHAPES = [(3, 300, 300), (2, 129, 520), (1, 40, 1000), (4, 1024, 1024),
               (2, 1500, 1500)]


@pytest.mark.parametrize("tile", [16, 128])
@pytest.mark.parametrize("BH,Sq,Sk", PLAN_SHAPES)
def test_items_count_the_unmasked_key_tiles(BH, Sq, Sk, tile):
    """The ping-pong planner's items at offsets 0, 37, 128, 512 and Sk - 1:
    each item's key tiles are the tiles holding a (row, key) pair the
    offset mask keeps, counted by brute force, and at offset 0 those of
    the call without one."""
    assert FK.items(BH, Sq, Sk, True, tile) == FK.items(
        BH, Sq, Sk, True, tile, 0)
    for off in (0, 37, 128, 512, Sk - 1):
        its = FK.items(BH, Sq, Sk, True, tile, off)
        assert len(its) == BH * -(-Sq // tile)
        for bh, q0, n in its:
            kept = _kept_offset(q0, Sq, Sk, tile, off)
            assert kept == set(range(n)), (off, q0)


@pytest.mark.parametrize("sms", [7, 132])
@pytest.mark.parametrize("BH,Sq,Sk", PLAN_SHAPES)
def test_plan_covers_the_offset_tiles_once(BH, Sq, Sk, sms):
    """The plan at offsets 37, 128 and Sk - 1: every kept (head, query
    tile, key tile) is covered by exactly one part, in order, and no other
    tile; the offset is part of the plan's cache key."""
    for off in (37, 128, Sk - 1):
        p = FK.plan(BH, Sq, Sk, True, sms, q_offset=off)
        tiles = {}
        for parts in p.blocks:
            for bh, q0, k0, k1, part, nparts, *_ in parts:
                tiles.setdefault((bh, q0), []).append((part, k0, k1))
        for (bh, q0), parts in tiles.items():
            got = [kt for _, k0, k1 in sorted(parts)
                   for kt in range(k0, k1)]
            assert got == sorted(_kept_offset(q0, Sq, Sk, FK.TILE, off))
        assert len(tiles) == BH * -(-Sq // FK.TILE)
    if Sq < Sk:
        assert FK.plan(BH, Sq, Sk, True, sms, q_offset=128) != FK.plan(
            BH, Sq, Sk, True, sms)


FUSED_SHAPES = [(2, 2, 300, 300), (1, 4, 200, 71), (3, 1, 71, 200),
                (1, 4, 3904, 3904), (2, 2, 64, 129), (1, 1, 200, 520)]


@pytest.mark.parametrize("BHkv,group,Sq,Sk", FUSED_SHAPES)
def test_fused_order_with_an_offset(BHkv, group, Sq, Sk):
    """The fused K7 design's dQ order (``test_torch_flash_bwd``'s mirror of
    the kernel) at offsets 37, 128, 512 and Sk - 1: per acc tile the turns
    are 0, 1, ... with none missing (key tile 0 reaches every query tile,
    and the first query tile a key tile reaches does not fall as the key
    tile grows), the consumers with a partial are exactly the 64-key
    halves the offset mask keeps, and the blocks run to the end on 1 and
    3 resident places."""
    for off in (37, 128, 512, Sk - 1):
        check_fused_order(BHkv, group, Sq, Sk, True, off)
        if Sq * Sk <= 300 * 300:
            for slots in (1, 3):
                run_fused_blocks(
                    fused_schedule(BHkv, group, Sq, Sk, True, off), slots)
