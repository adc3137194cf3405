"""A query offset through the port's attention, against the JAX package on
the CPU: under the causal mask query row i sits at position q_offset + i
and keeps keys 0..q_offset + i (keys counting from 0), and the rope
positions of a layer are q_offset + arange(S), as in the reference's
``chunked_attention``, ``attn_train``, ``mla_train`` and ``block_train``.

Inputs are drawn with numpy (the layers' weights with
``torch_cross.numpy_params`` from the reference's descriptors) and handed
to both packages; on the CPU the port runs K6's and K7's plain versions.
Offsets 0, 37, 128 and Sk - 1 (which keeps every key), and the negative
offsets -1, -37, -(Sq - 1), -Sq and -Sq - 5, under which the first rows
keep no key: the reference's finite -1e30 mask gives each such row the
mean of v over all keys, and the port splits those rows off in
``ops.flash_attention``. Sq = Sk and Sq < Sk. Tolerances, f32: outputs
within 2e-5 (``chunked_attention``: relative and absolute; the layers: of
the output's largest element), gradients within 1e-4 of each gradient's
largest element.

The gradients' oracle is ``jax.vjp`` of the reference: at offsets >= 0
through its custom VJP (``_flash_core_bwd``); at negative offsets through
its forward itself (:func:`true_gradient` sets ``_flash_core`` to the
un-customised ``_flash_fwd_impl`` for the test's duration), because at a
key-less row ``_flash_core_bwd`` is not the gradient of the forward: the
row's lse is exactly -1e30, so its p = exp(s - lse) is 1 on every key
where the forward's is 1 / Sk. Two tests pin the oracle against the
custom VJP.

The kernels' offset arithmetic is held here through its host side (the
ping-pong plan's key tiles against a brute-force count of the unmasked
tiles, and the fused K7 design's order of dQ additions); on the card
``chip_smoke.py`` holds every K6 and K7 variant against its plain version
at offsets 37 and 128, and ``ops.flash_attention`` at -37, -128 and -Sq.
"""
import contextlib
import functools
from unittest import mock

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


def _negative_offsets(Sq):
    """-1, -37, and around -Sq: the last row with a key, none, and past."""
    return (-1, -37, -(Sq - 1), -Sq, -Sq - 5)


def _autodiff_core(q, k, v, causal, q_offset, q_chunk, kv_chunk, scale):
    """The reference's ``_flash_core`` without its custom VJP."""
    o, _ = JA._flash_fwd_impl(q, k, v, causal, q_offset, q_chunk, kv_chunk,
                              scale)
    return o.astype(q.dtype)


@contextlib.contextmanager
def true_gradient(on: bool = True):
    """While active (and ``on``), the reference's attention differentiates
    its own forward under ``jax.vjp`` instead of running
    ``_flash_core_bwd``; its forward is unchanged."""
    with (mock.patch.object(JA, "_flash_core", _autodiff_core) if on
          else contextlib.nullcontext()):
        yield


# (Sq, Sk, group, D, Dv, q_offset): Sq = Sk and Sq < Sk, group 1 and 4,
# D = Dv and D != Dv, the four offsets >= 0 and the five negative ones
CASES = [(Sq, Sk, group, D, Dv, off)
         for Sq, Sk in ((160, 160), (40, 160))
         for group in (1, 4)
         for D, Dv in ((16, 16), (24, 16))
         for off in _offsets(Sk) + _negative_offsets(Sq)]


@functools.lru_cache(maxsize=None)
def _attention_case(Sq, Sk, group, D, Dv, off, autodiff=None,
                    zero_keyless=False):
    """(q, k, v, do) numpy and the reference's jitted forward and
    ``jax.vjp`` of ``chunked_attention`` at query offset ``off`` (q
    chunks of up to 16 rows, kv chunks of up to 32): through the forward
    itself (``autodiff``, by default at negative offsets) or the custom
    VJP. ``zero_keyless``: do is zero on the rows that keep no key."""
    rng = np.random.default_rng([Sq, Sk, group, D, Dv, off] if off >= 0
                                else [Sq, Sk, group, D, Dv, -off, 1])
    KH = H // group
    args = (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, Dv)).astype(np.float32),
            rng.standard_normal((B, Sq, H, Dv)).astype(np.float32))
    if zero_keyless:
        args[3][:, :max(-off, 0)] = 0
    f = lambda q, k, v: JA.chunked_attention(
        q, k, v, causal=True, q_offset=off, q_chunk=16, kv_chunk=32)

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)
    with true_gradient(off < 0 if autodiff is None else autodiff):
        o, grads = jax.jit(fwd_bwd)(*(jnp.asarray(a) for a in args))
    return args, np.asarray(o), [np.asarray(g) for g in grads]


def _rel_err(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _grad_errs(got, want):
    """Each gradient's max abs error over its largest element; where the
    reference's gradient is exactly zero, over the largest element of all
    of them. (A row that keeps one key has no gradient in q or k: its
    softmax is 1 whatever the score. The reference's autodiff gives exact
    zeros there, the port's plain backward f32 rounding of dp - Dsum, and
    an error over a largest element of 0 would be infinite.)"""
    got, want = [to_np(g) for g in got], [to_np(w) for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape
        errs.append(float(np.abs(g - w).max())
                    / max(float(np.abs(w).max()) or top, 1e-30))
    return errs


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
    logsumexp, then K7's plain version; at a negative offset the key-less
    rows' mean and its gradient beside them) against ``jax.vjp`` of the
    reference's (its ``_flash_core_bwd`` at offsets >= 0, the gradient of
    its forward at negative ones), each within 1e-4 of its largest
    element."""
    (q, k, v, do), _, want = _attention_case(Sq, Sk, group, D, Dv, off)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = TA.chunked_attention(qt, kt, vt, q_offset=off)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    for name, err in zip("qkv", _grad_errs(got, want)):
        assert err <= GRAD_TOL, (name, err)


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
    """The five kernel-level entries (K6's and K7's wrappers and their
    plain versions) refuse a negative offset with ValueError, with or
    without the mask: at a key-less row their p = exp(s - lse) form would
    copy the reference's backward fault, so ``ops.flash_attention`` splits
    such rows off before it calls them. The kernel wrappers refuse it
    before they look at the tensors' device."""
    f = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    calls = [
        lambda c: FR.flash_attention_ref(f, f, f, causal=c, q_offset=-1),
        lambda c: FR.flash_attention_lse_ref(f, f, f, causal=c, q_offset=-8),
        lambda c: FR.flash_attention_bwd_ref(f, f, f, f, lse, f, causal=c,
                                             q_offset=-1),
        lambda c: FK.flash_attention_cuda(f, f, f, causal=c, q_offset=-1),
        lambda c: BK.flash_attention_bwd_cuda(f, f, f, f, lse, f, causal=c,
                                              q_offset=-1),
    ]
    for call in calls:
        for causal in (True, False):
            with pytest.raises(ValueError, match="q_offset"):
                call(causal)


@pytest.mark.parametrize("Sq,Sk", [(160, 160), (40, 160)])
def test_the_oracle_is_the_custom_vjp_from_offset_0(Sq, Sk):
    """At offsets >= 0 every row keeps a key, and ``jax.vjp`` of the
    reference's forward (the negative offsets' oracle) equals its custom
    VJP within 1e-5 of each gradient's largest element."""
    for off in _offsets(Sk):
        _, o_a, want = _attention_case(Sq, Sk, 4, 24, 16, off, True)
        _, o_c, got = _attention_case(Sq, Sk, 4, 24, 16, off, False)
        np.testing.assert_array_equal(o_a, o_c)
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= 1e-5, (off, _rel_err(g, w))


@pytest.mark.parametrize("Sq,Sk", [(160, 160), (40, 160)])
def test_the_oracle_at_a_negative_offset(Sq, Sk):
    """At a negative offset the reference's custom VJP equals the gradient
    of its forward only where dO is zero on the key-less rows (within
    1e-5 of each gradient's largest element); with dO on those rows its
    dq, dk and dv are all further from it than 1e-2 of that element
    (``_flash_core_bwd`` takes p = 1 on every key of such a row, and a
    nonzero ds), so the port's tests hold the gradient of the forward."""
    for off in (-1, -37):
        for zero in (True, False):
            _, o_a, want = _attention_case(Sq, Sk, 4, 24, 16, off, True,
                                           zero)
            _, o_c, got = _attention_case(Sq, Sk, 4, 24, 16, off, False,
                                          zero)
            np.testing.assert_array_equal(o_a, o_c)
            errs = [_rel_err(g, w) for g, w in zip(got, want)]
            if zero:
                assert max(errs) <= 1e-5, (off, errs)
            else:
                assert min(errs) > 1e-2, (off, errs)


def test_the_custom_vjp_at_key_less_rows():
    """The reference-side fault on record (ROADMAP §3), at f32, Sq = Sk =
    8, H = 2, KH = 1, D = 4, offset -3, chunks of 4, numpy seed 0: the
    key-less rows' output is the mean of v within 3e-8 and their lse is
    exactly -1e30, and the custom VJP's dq, dk and dv each differ from
    ``jax.vjp`` of the forward by more than 1 (3.13, 2.87 and 4.59 on
    these draws); the port's gradient is the latter's."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, 8, 2, 4), (1, 8, 1, 4), (1, 8, 1, 4),
                             (1, 8, 2, 4)))
    f = lambda q_, k_, v_: JA.chunked_attention(q_, k_, v_, q_offset=-3,
                                                q_chunk=4, kv_chunk=4)
    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    custom = vjp(jnp.asarray(do))
    with true_gradient():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        true = vjp(jnp.asarray(do))
    _, lse = JA._flash_fwd_impl(jnp.asarray(q).reshape(1, 8, 1, 2, 4),
                                jnp.asarray(k), jnp.asarray(v), True, -3, 4,
                                4, 0.5)
    assert np.abs(np.asarray(o)[:, :3] - v.mean(1)[:, None]).max() <= 3e-8
    assert (np.asarray(lse)[..., :3] == -1e30).all()
    for c, t in zip(custom, true):
        assert np.abs(np.asarray(c) - np.asarray(t)).max() > 1
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(TA.chunked_attention(*ts, q_offset=-3), ts,
                              torch.from_numpy(do))
    for name, err in zip("qkv", _grad_errs(got, true)):
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("off", [-1, -3, -7, -9])
def test_negative_offset_gradcheck_f64(off, group):
    """``ops.FlashAttention`` at negative offsets (rows ..min(-off, 7)
    keep no key; -7 and -9 leave none with a key) under
    ``torch.autograd.gradcheck`` in f64: its hand-written backward is the
    gradient of its forward."""
    g = torch.Generator().manual_seed(17 - off + group)
    q = torch.randn(6, 7, 5, generator=g, dtype=torch.float64)
    k = torch.randn(6 // group, 9, 5, generator=g, dtype=torch.float64)
    v = torch.randn(6 // group, 9, 4, generator=g, dtype=torch.float64)
    args = [t.requires_grad_() for t in (q, k, v)]
    fn = lambda q_, k_, v_: FA.FlashAttention.apply(q_, k_, v_, group, True,
                                                    None, None, off)
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [-37, -40, -100])
def test_keyless_rows_are_the_mean_of_v(off, dtype):
    """Rows ..min(-off, Sq) of ``ops.flash_attention`` are each kv head's
    mean of v over all keys, summed in f32 and cast to q's dtype, for
    every query head of its group; rows past them are the offset-0 call
    on ``q[:, n0:]``, the same bits; with a gradient and without, the
    same output."""
    Sq, Sk, group = 40, 64, 2
    g = torch.Generator().manual_seed(-off)
    q = torch.randn(6, Sq, 16, generator=g).to(dtype)
    k = torch.randn(3, Sk, 16, generator=g).to(dtype)
    v = torch.randn(3, Sk, 8, generator=g).to(dtype)
    n0 = min(-off, Sq)
    got = FA.flash_attention(q, k, v, group=group, q_offset=off)
    trained = FA.flash_attention(q.clone().requires_grad_(), k, v,
                                 group=group, q_offset=off)
    assert got.dtype == dtype and got.shape == (6, Sq, 8)
    assert torch.equal(got, trained.detach())
    mean = v.float().sum(1) / Sk
    want = mean.to(dtype)[torch.arange(6) // group]
    torch.testing.assert_close(got[:, :n0].float(),
                               want[:, None].expand(-1, n0, -1).float(),
                               rtol=0, atol=1e-6)
    if n0 < Sq:
        rest = FA.flash_attention(q[:, n0:], k, v, group=group)
        assert torch.equal(got[:, n0:], rest)


@pytest.mark.parametrize("off,n0", [(-37, 37), (-40, 40), (-100, 40),
                                    (5, 0)])
def test_the_split_calls_the_offset_0_problem(off, n0):
    """Forward and backward at a negative offset call the plain K6 and K7
    once each on the rows n0.. at offset 0, and neither when no row keeps
    a key (on the card: K6 and K7 launch once each, or not at all); an
    offset >= 0 reaches them unchanged."""
    Sq = 40
    q = torch.randn(4, Sq, 16, requires_grad=True)
    k = torch.randn(2, 64, 16, requires_grad=True)
    v = torch.randn(2, 64, 16, requires_grad=True)
    calls = []

    def spy(name):
        fn = getattr(FR, name)

        def wrapper(q_, *a, **kw):
            calls.append((name, q_.shape[1], kw["q_offset"]))
            return fn(q_, *a, **kw)
        return wrapper
    names = ("flash_attention_lse_ref", "flash_attention_bwd_ref")
    with mock.patch.multiple(FR, **{n: spy(n) for n in names}):
        o = FA.flash_attention(q, k, v, group=2, q_offset=off)
        o.backward(torch.ones_like(o))
    want = [] if n0 == Sq else [(n, Sq - n0, max(off, 0)) for n in names]
    assert calls == want
    assert torch.equal(q.grad[:, :n0], torch.zeros_like(q.grad[:, :n0]))


def test_a_negative_offset_without_the_mask_is_ignored():
    """Without the causal mask the offset means nothing at any sign, as in
    the reference: ``chunked_attention(causal=False)`` at -5 and -100
    equals it at 0, output and gradients, bit for bit; and both equal the
    reference's within 2e-5."""
    rng = np.random.default_rng(23)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 24, H, 16), (B, 40, 2, 16), (B, 40, 2, 16)))
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, q_offset=-5,
                                q_chunk=8, kv_chunk=8)
    runs = []
    for off in (0, -5, -100):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = TA.chunked_attention(*ts, causal=False, q_offset=off)
        runs.append([o] + list(torch.autograd.grad(o.sum(), ts)))
        np.testing.assert_allclose(to_np(o), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


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


LAYER_OFFSETS = _offsets(S) + _negative_offsets(S)


@pytest.mark.parametrize("off", LAYER_OFFSETS)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_offset_matches_jax(layer, off):
    """``attn_train``, ``mla_train`` and ``block_train`` (granite-3-2b's
    and deepseek-v3's, MLA, REDUCED, f32) over positions off..off+47: the
    output within 2e-5 of its largest element, and the gradients of x and
    of every parameter (a numpy cotangent) within 1e-4 of each one's
    largest element, against the reference's under ``jax.vjp`` (of its
    forward itself at a negative offset, :func:`true_gradient`)."""
    arch, descs, jfn, tfn = LAYERS[layer]
    jc, tc = _cfgs(arch)
    params = numpy_params(descs(jc))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)

    def fwd_bwd(p, x_, dy_):
        y, vjp = jax.vjp(lambda p_, x__: jfn(p_, x__, jc, off), p, x_)
        return y, vjp(dy_)
    with true_gradient(off < 0):
        want, (gp, gx) = jax.jit(fwd_bwd)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(dy))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), _torch_tree(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(tp, xt, tc, off)
    assert _rel_err(got, want) <= TOL, _rel_err(got, want)
    tl = leaves(tp)
    grads = torch.autograd.grad(got, [xt] + list(tl.values()),
                                torch.from_numpy(dy))
    wl = leaves(gp)
    assert set(wl) == set(tl)
    errs = _grad_errs(grads, [gx] + [wl[path] for path in tl])
    for path, err in zip([("x",)] + list(tl), errs):
        assert err <= GRAD_TOL, ("/".join(path), err)


@pytest.mark.parametrize("off", LAYER_OFFSETS)
@pytest.mark.parametrize("layer", ["attn_train", "mla_train"])
def test_layer_offset_rotates_the_cache_entries(layer, off):
    """The keys ``attn_train`` and ``mla_train`` return for the cache
    (``return_kv``: k and v; the latent c_kv and k_rope) are rotated at
    positions off..off+47 (negative ones too), as the reference's: within
    the output's
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
