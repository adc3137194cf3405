"""The gradient of the port's flash attention on the CPU:
``ref.flash_attention_bwd_ref`` (the plain version of K7) against
``jax.vjp`` of the reference's ``chunked_attention`` (its ``custom_vjp``
backward, ``_flash_core_bwd``) and against torch autograd through the
plain forward; ``ops.FlashAttention`` under ``gradcheck`` in f64; the
forward's logsumexp; K7's variant choice; and a plain model of the
rounding points of K7's tensor-core (``wgmma``) kernels, held to the
card tests' bf16 rule against the f32 gradient and against the
reference's.

Inputs are drawn with numpy and handed to both packages, in the
reference's (B, S, H, D) layout, flattened to (B*H, S, D) as the port's
``models.attention.chunked_attention`` does. f32 tolerance 1e-5 of each
gradient's largest element (the reference sums over chunk pairs, the
plain version over whole rows).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from repro.models import attention as JA
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FR

TOL = 1e-5


def _flat(x, B, S, H):
    """(B, S, H, D) numpy -> (B*H, S, D) torch, as chunked_attention."""
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B * H, S, -1)))


def _err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _inputs(rng, B, Sq, Sk, H, KH, D, Dv):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, Dv)).astype(np.float32),
            rng.standard_normal((B, Sq, H, Dv)).astype(np.float32))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(100, 100, 16, 16), (37, 37, 8, 12),
                                        (60, 90, 16, 8)])
def test_bwd_ref_matches_jax_custom_vjp(rng, group, causal, Sq, Sk, D, Dv):
    """Several chunk pairs on the reference's side (q chunks of up to 16,
    kv chunks of up to 24 rows, divisors of ragged lengths); both masks
    are top-left, also for Sq != Sk."""
    B, KH = 2, 2
    H = KH * group
    q, k, v, do = _inputs(rng, B, Sq, Sk, H, KH, D, Dv)
    f = lambda q_, k_, v_: JA.chunked_attention(
        q_, k_, v_, causal=causal, q_chunk=16, kv_chunk=24)

    def fwd_bwd(q_, k_, v_, do_):
        o_, vjp = jax.vjp(f, q_, k_, v_)
        return o_, vjp(do_)

    o_j, (dq_j, dk_j, dv_j) = jax.jit(fwd_bwd)(
        *(jnp.asarray(x) for x in (q, k, v, do)))

    tq, tk, tv = _flat(q, B, Sq, H), _flat(k, B, Sk, KH), _flat(v, B, Sk, KH)
    o, lse = FR.flash_attention_lse_ref(tq, tk, tv, group=group,
                                        causal=causal)
    dq, dk, dv = FR.flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                            _flat(do, B, Sq, H),
                                            group=group, causal=causal)
    unflat = lambda t, S, n: t.reshape(B, n, S, -1).transpose(1, 2)
    assert _err(unflat(o, Sq, H), o_j) <= TOL
    assert _err(unflat(dq, Sq, H), dq_j) <= TOL
    assert _err(unflat(dk, Sk, KH), dk_j) <= TOL
    assert _err(unflat(dv, Sk, KH), dv_j) <= TOL


@pytest.mark.parametrize("group,causal,Sq,Sk", [(1, True, 45, 45),
                                                (4, True, 33, 33),
                                                (2, False, 20, 51)])
def test_bwd_ref_matches_torch_autograd(rng, group, causal, Sq, Sk):
    """The plain backward against autograd through the plain forward, and
    the forward's lse against the logsumexp of the masked scores."""
    BH, D, Dv = 8, 16, 8
    q = torch.from_numpy(rng.standard_normal((BH, Sq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((BH // group, Sk, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((BH // group, Sk, Dv)).astype(
        np.float32))
    do = torch.from_numpy(rng.standard_normal((BH, Sq, Dv)).astype(
        np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FR.flash_attention_ref(*leaves, group=group, causal=causal)
    out.backward(do)
    o, lse = FR.flash_attention_lse_ref(q, k, v, group=group, causal=causal)
    assert torch.equal(o, out.detach())
    got = FR.flash_attention_bwd_ref(q, k, v, o, lse, do, group=group,
                                     causal=causal)
    for a, leaf in zip(got, leaves):
        assert _err(a, leaf.grad.numpy()) <= TOL
    s = np.einsum("bqd,bkd->bqk", q.numpy(),
                  np.repeat(k.numpy(), group, 0)) * D ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((Sq, Sk), bool)), s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(logsumexp(s, -1)),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3])
def test_flash_attention_function_gradcheck_f64(causal, group):
    """``FlashAttention`` (forward with lse, plain backward on the CPU)
    under ``torch.autograd.gradcheck`` in f64 on a tiny shape."""
    g = torch.Generator().manual_seed(7 + group)
    q = torch.randn(6, 7, 5, generator=g, dtype=torch.float64)
    k = torch.randn(6 // group, 7, 5, generator=g, dtype=torch.float64)
    v = torch.randn(6 // group, 7, 4, generator=g, dtype=torch.float64)
    args = [t.requires_grad_() for t in (q, k, v)]
    fn = lambda q_, k_, v_: FA.flash_attention(q_, k_, v_, group=group,
                                               causal=causal)
    assert torch.autograd.gradcheck(fn, args)


def test_flash_attention_takes_the_function_only_with_grad(rng):
    """With grad enabled and an input that requires it, flash_attention
    returns an output with a gradient; serving (no grad) does not; on the
    CPU neither launches a kernel; K7's wrapper refuses CPU tensors."""
    q = torch.from_numpy(rng.standard_normal((4, 9, 8)).astype(np.float32))
    kv = q[::2].contiguous()
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    out = FA.flash_attention(q.clone().requires_grad_(), kv, kv, group=2)
    assert out.grad_fn is not None
    with torch.no_grad():
        served = FA.flash_attention(q.clone().requires_grad_(), kv, kv,
                                    group=2)
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())
    out.sum().backward()
    assert AK.KERNEL.launches == BK.KERNEL.launches == 0
    o, lse = FR.flash_attention_lse_ref(q, kv, kv, group=2)
    with pytest.raises(ValueError, match="on the card"):
        BK.flash_attention_bwd_cuda(q, kv, kv, o, lse, o, group=2)
    with pytest.raises(ValueError, match="group"):
        BK.flash_attention_bwd_cuda(q, kv, kv, o, lse, o, group=3)


# -- K7's variants --------------------------------------------------------------

SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                   "csrc", "flash_attention_bwd.cu")


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 64, 64, "pingpong"),
    (torch.bfloat16, 128, 128, "pingpong"),
    (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 64, 128, "simt"), (torch.bfloat16, 128, 64, "simt"),
    (torch.bfloat16, 16, 16, "simt"), (torch.bfloat16, 96, 96, "simt"),
    (torch.bfloat16, 32, 32, "simt"), (torch.float32, 64, 64, "simt"),
    (torch.float32, 128, 128, "simt"), (torch.float32, 16, 8, "simt"),
    (torch.float32, 192, 128, "simt"), (torch.bfloat16, 80, 80, "wgmma"),
    (torch.float32, 80, 80, "simt"),
    (torch.bfloat16, 192, 64, "simt"), (torch.bfloat16, 160, 64, "simt"),
    (torch.bfloat16, 256, 256, "simt")])
def test_bwd_variant_choice(dtype, D, Dv, want):
    """K7 takes K6's rule: its tensor cores for bf16 with (D, Dv) in
    {(64, 64), (80, 80), (128, 128), (192, 128)} (K6's ``pingpong`` at 64
    and 128, ``wgmma`` at the others), ``simt`` otherwise. A forced
    ``"wgmma"`` on inputs that do not
    qualify raises before anything is built; on inputs that do, the
    wrapper goes on to its checks (and refuses CPU tensors). The scratch
    is Dsum for simt, lse and Dsum over rows padded to ROW_PAD for
    wgmma."""
    assert AK.variant(dtype, D, Dv) == want
    q = torch.zeros(4, 9, D, dtype=dtype)
    kv = torch.zeros(2, 9, D, dtype=dtype)
    v = torch.zeros(2, 9, Dv, dtype=dtype)
    o = torch.zeros(4, 9, Dv, dtype=dtype)
    lse = torch.zeros(4, 9)
    if want != "simt":
        with pytest.raises(ValueError, match="on the card"):
            BK.flash_attention_bwd_cuda(q, kv, v, o, lse, o, group=2,
                                        force_variant="wgmma")
    else:
        with pytest.raises(ValueError, match="wgmma kernels take bf16"):
            BK.flash_attention_bwd_cuda(q, kv, v, o, lse, o, group=2,
                                        force_variant="wgmma")
    with pytest.raises(ValueError, match="on the card"):
        BK.flash_attention_bwd_cuda(q, kv, v, o, lse, o, group=2,
                                    force_variant="simt")
    with pytest.raises(ValueError, match="unknown variant"):
        BK.flash_attention_bwd_cuda(q, kv, v, o, lse, o, group=2,
                                    force_variant="tf32")
    assert BK.scratch_numel("simt", 4, 9) == 36
    assert BK.scratch_numel("wgmma", 4, 9) == 2 * 4 * BK.ROW_PAD
    assert BK.scratch_numel("wgmma", 3, 2 * BK.ROW_PAD + 1) == \
        2 * 3 * 3 * BK.ROW_PAD
    assert BK.KERNEL.launches == 0


@pytest.mark.parametrize("D,Dv,want", [(192, 128, "wgmma"),
                                       (129, 129, "simt"),
                                       (64, 192, "simt")])
def test_bwd_takes_head_dims_to_256_and_refuses_past_it(D, Dv, want):
    """K7 takes K6's head dims, up to 256 with D != Dv (MLA's D = 192,
    Dv = 128 among them, on the wgmma kernels in bf16): these reach the
    wrapper's device checks (and CPU tensors are refused there), a head
    dim of 257 is refused before anything is built or launched, and the
    limit is the source's."""
    assert BK.MAX_HEAD_DIM == AK.MAX_HEAD_DIM == 256
    assert AK.variant(torch.bfloat16, D, Dv) == want
    q = torch.zeros(4, 9, D, dtype=torch.bfloat16)
    v = torch.zeros(4, 9, Dv, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        BK.flash_attention_bwd_cuda(q, q, v, v, torch.zeros(4, 9), v)
    for d, dv in ((BK.MAX_HEAD_DIM + 1, Dv), (D, BK.MAX_HEAD_DIM + 1)):
        q = torch.zeros(4, 9, d, dtype=torch.bfloat16)
        v = torch.zeros(4, 9, dv, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            BK.flash_attention_bwd_cuda(q, q, v, v, torch.zeros(4, 9), v)
    src = open(SRC).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxHeadDim"]) == BK.MAX_HEAD_DIM
    assert BK.KERNEL._fn is None and BK.KERNEL.launches == 0


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("D,Dv", [(192, 128), (256, 256)])
def test_bwd_ref_matches_jax_at_wide_head_dims(rng, D, Dv, group):
    """The plain backward at MLA's head dims (192, 128) and at K7's limit
    (256, 256) against ``jax.vjp`` of the reference's attention, with
    MLA's scale (D ** -0.5), causal, over several chunk pairs."""
    B, KH, Sq = 2, 2, 40
    H = KH * group
    q, k, v, do = _inputs(rng, B, Sq, Sq, H, KH, D, Dv)
    f = lambda q_, k_, v_: JA.chunked_attention(q_, k_, v_, causal=True,
                                                q_chunk=16, kv_chunk=24)

    def fwd_bwd(q_, k_, v_, do_):
        o_, vjp = jax.vjp(f, q_, k_, v_)
        return o_, vjp(do_)

    o_j, grads_j = jax.jit(fwd_bwd)(*(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv = _flat(q, B, Sq, H), _flat(k, B, Sq, KH), _flat(v, B, Sq, KH)
    o, lse = FR.flash_attention_lse_ref(tq, tk, tv, group=group)
    got = FR.flash_attention_bwd_ref(tq, tk, tv, o, lse, _flat(do, B, Sq, H),
                                     group=group)
    unflat = lambda t, n: t.reshape(B, n, Sq, -1).transpose(1, 2)
    assert _err(unflat(o, H), o_j) <= TOL
    for g, want, n in zip(got, grads_j, (H, KH, KH)):
        assert _err(unflat(g, n), want) <= TOL


def test_bwd_row_pad_matches_the_source():
    """The wrapper's ROW_PAD is the kernel's kRowPad, and every query tile
    of the wgmma kernels, those of the D = 192 instance too, divides it (a
    tile's lse and Dsum slices stay inside a head's padded rows)."""
    src = open(SRC).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kRowPad"]) == BK.ROW_PAD
    for tile in ("kDkdvBQ", "kDkdvBQWide", "kDqBQ"):
        assert BK.ROW_PAD % int(consts[tile]) == 0


# -- the rounding points of K7's wgmma kernels -----------------------------------

LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _pair(x, split):
    """The bf16 A operands a tensor-core product takes for f32 x: hi =
    bf16(x) and lo = bf16(x - hi), or hi alone."""
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if split else [hi]


def wgmma_model(q, k, v, o, lse, do, *, group, causal, split_p=True,
                split_ds=True, dq_tile=None):
    """The wgmma kernels' arithmetic in plain torch (f32 on bf16 inputs), at
    any head dims D (q, k) and Dv (v, o, do), scale D ** -0.5:
    S and dP from bf16 operands in f32; p = 2^(s scale log2 e - lse log2
    e); ds = p (dp - Dsum) scale; p enters dV = P^T dO and ds enters
    dK = dS^T Q and dQ = dS K as bf16 hi and lo pairs (a single bf16
    rounding with ``split_p`` / ``split_ds`` False); dk, dv summed over
    the group, outputs rounded to bf16 once. With ``dq_tile`` (the fused
    design's keys per consumer), dq is the f32 sum of per-tile partials
    (dS_hi + dS_lo) K, taken in the fused kernel's order: the first
    tile's stored, the later ones added one by one, then rounded once."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = v.shape
    scale = D ** -0.5
    kv = torch.arange(BH) // group
    kk, vv, qq, dd = k[kv].float(), v[kv].float(), q.float(), do.float()
    s = torch.einsum("bqd,bkd->bqk", qq, kk)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool).tril()
        p = torch.where(keep[None], p, 0.0)
    dsum = (dd * o.float()).sum(-1)
    dv = sum(torch.einsum("bqk,bqe->bke", a, dd) for a in _pair(p, split_p))
    dp = torch.einsum("bqe,bke->bqk", dd, vv)
    ds = p * (dp - dsum[..., None]) * scale
    parts = _pair(ds, split_ds)
    if dq_tile is None:
        dq = sum(torch.einsum("bqk,bkd->bqd", a, kk) for a in parts)
    else:
        dq = None
        for k0 in range(0, Sk, dq_tile):
            cut = slice(k0, k0 + dq_tile)
            part = sum(torch.einsum("bqk,bkd->bqd", a[..., cut], kk[:, cut])
                       for a in parts)
            dq = part if dq is None else dq + part
    dk = sum(torch.einsum("bqk,bqd->bkd", a, qq) for a in parts)
    dk = dk.reshape(BHkv, group, Sk, D).sum(1)
    dv = dv.reshape(BHkv, group, Sk, Dv).sum(1)
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _grad_err(got, want):
    """max |got - want| over max |want|, the worst of dq, dk, dv (the card
    tests' measure)."""
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def _bf16_case(seed, BH, S, D, group, causal, Dv=None):
    """bf16 q, k (head dim D), v, do (Dv, default D) from numpy; o and lse
    from the plain forward (as K6 gives them, at the scale D ** -0.5); the
    bf16 and f32 plain gradients."""
    Dv = D if Dv is None else Dv
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    q, do = mk(BH, S, D), mk(BH, S, Dv)
    k, v = mk(BH // group, S, D), mk(BH // group, S, Dv)
    o, lse = FR.flash_attention_lse_ref(q, k, v, group=group, causal=causal)
    plain = FR.flash_attention_bwd_ref(q, k, v, o, lse, do, group=group,
                                       causal=causal)
    f32 = FR.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                     lse, do.float(), group=group,
                                     causal=causal)
    return (q, k, v, o, lse, do), plain, f32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_wgmma_rounding_model_holds_the_bf16_rule(causal, group):
    """Over seeds 0-3 at BH 8, S 256, D 64: the wgmma kernels' rounding
    points keep the gradient no further from the f32 gradient than the
    plain bf16 gradient is, x1.5 (the rule the card tests and
    chip_smoke.py hold K7 to)."""
    for seed in range(4):
        args, plain, f32 = _bf16_case(seed, 8, 256, 64, group, causal)
        got = wgmma_model(*args, group=group, causal=causal)
        for a, b in zip(got, plain):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _grad_err(got, f32) <= 1.5 * _grad_err(plain, f32), seed


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_wgmma_rounding_model_holds_the_bf16_rule_at_mla_head_dims(causal,
                                                                   group):
    """The same rule over seeds 0-3 at MLA's head dims (D = 192, Dv = 128,
    scale 192 ** -0.5) on BH 4, S 128: the hi / lo pairs hold it at the
    widths of the (192, 128) wgmma instances too."""
    for seed in range(4):
        args, plain, f32 = _bf16_case(seed, 4, 128, 192, group, causal,
                                      Dv=128)
        got = wgmma_model(*args, group=group, causal=causal)
        for a, b in zip(got, plain):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert got[2].shape[-1] == 128 and got[0].shape[-1] == 192
        assert _grad_err(got, f32) <= 1.5 * _grad_err(plain, f32), seed


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("D,S", [(64, 45), (64, 300), (128, 150)])
def test_fused_dq_model_holds_the_bf16_rule(D, S, group, causal):
    """Over seeds 0-3 at BH 8, ragged S (one to five 64-key halves of the
    128-key tiles), D 64 and 128: the fused design's dq, f32 partials per
    consumer (64 keys) summed in its order and rounded once, keeps the
    gradient no further from the f32 gradient than the plain bf16 gradient
    is, x1.5."""
    c = _consts()
    tile = int(c["kDkdvBK"]) // int(c["kConsumers"])
    for seed in range(4):
        args, plain, f32 = _bf16_case(seed, 8, S, D, group, causal)
        got = wgmma_model(*args, group=group, causal=causal, dq_tile=tile)
        assert got[0].shape == plain[0].shape
        assert _grad_err(got, f32) <= 1.5 * _grad_err(plain, f32), seed


# -- the fused design's order of dQ's additions ---------------------------------

def _consts():
    return dict(re.findall(r"constexpr int (k\w+) = (\d+);", open(SRC).read()))


def fused_schedule(BHkv, group, Sq, Sk, causal, q_offset=0):
    """A mirror of attn_bwd_fused_wgmma_kernel's order, from the source's
    tiles: {ticket: (kvh, kt, [(q head, query tile, {consumer: turn})
    per step])}, the ticket kt * BHkv + kvh, the walk from the last query
    tile down to the first that reaches the block's keys (causal) or to
    0, heads inside. Consumer cw (keys 128 kt + 64 cw ..) adds its dQ
    partial of a step to acc tile (q head, query tile) once that tile's
    counter reads its turn, kConsumers kt + cw; under the causal mask a
    consumer whose keys all lie past the tile only takes its turn, with
    no partial (turn None here). ``q_offset``: the causal mask keeps key
    j for query row i when j <= q_offset + i."""
    c = _consts()
    BQ, BKT, NC = int(c["kDkdvBQ"]), int(c["kDkdvBK"]), int(c["kConsumers"])
    half = BKT // NC
    nq, nk = -(-Sq // BQ), -(-Sk // BKT)
    blocks = {}
    for ticket in range(nk * BHkv):
        kvh, kt = ticket % BHkv, ticket // BHkv
        qt0 = min(max(kt * BKT - q_offset, 0) // BQ, nq) if causal else 0
        steps = []
        for it in range((nq - qt0) * group):
            qt = nq - 1 - it // group
            turns = {cw: (None if causal and min((qt + 1) * BQ, Sq)
                          + q_offset <= kt * BKT + half * cw
                          else NC * kt + cw)
                     for cw in range(NC)}
            steps.append((kvh * group + it % group, qt, turns))
        blocks[ticket] = (kvh, kt, steps)
    return blocks


_ORDER_SHAPES = [(2, 2, 300, 300), (1, 4, 200, 71), (3, 1, 71, 200),
                 (2, 1, 1500, 1500), (1, 4, 3904, 3904), (2, 2, 64, 129),
                 (1, 1, 200, 60)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,group,Sq,Sk", _ORDER_SHAPES)
def test_fused_order_is_the_masks_key_tiles(BHkv, group, Sq, Sk, causal):
    """Per acc tile (q head, 64-row query tile), the counter values its
    contributors wait for are 0, 1, ... in turn (the first stores, so acc
    needs no memset); those with a partial are, among the 64-key halves
    of the key tiles that hold a key < Sk, exactly the halves the mask
    keeps for the tile (a pair key <= query, both in range, for the causal
    mask); each turn but the first waits for consumer 0 of its own block
    or for consumer 1 of key tile kt - 1 of its kv head, a lower ticket;
    and every block of a kv head meets a tile at the same step."""
    check_fused_order(BHkv, group, Sq, Sk, causal)


def check_fused_order(BHkv, group, Sq, Sk, causal, q_offset=0):
    """The checks of :func:`test_fused_order_is_the_masks_key_tiles` on
    :func:`fused_schedule` at query offset ``q_offset`` (the causal mask
    keeping key <= q_offset + query)."""
    c = _consts()
    BQ, BKT, NC = int(c["kDkdvBQ"]), int(c["kDkdvBK"]), int(c["kConsumers"])
    half = BKT // NC
    blocks = fused_schedule(BHkv, group, Sq, Sk, causal, q_offset)
    ticket = {(kvh, kt): t for t, (kvh, kt, _) in blocks.items()}
    turns, parts, step_of = {}, {}, {}
    for t, (kvh, kt, steps) in blocks.items():
        for i, (bh, qt, by_cw) in enumerate(steps):
            for cw, turn in by_cw.items():
                turns.setdefault((bh, qt), []).append(NC * kt + cw)
                if turn is not None:
                    parts.setdefault((bh, qt), set()).add((kt, cw))
            step_of.setdefault((bh, qt), set()).add(i)
    qpos, kpos = np.arange(Sq), np.arange(Sk)
    keep = (kpos[None, :] <= qpos[:, None] + q_offset) if causal else np.ones(
        (Sq, Sk), bool)
    nq, nk = -(-Sq // BQ), -(-Sk // BKT)
    for bh in range(BHkv * group):
        for qt in range(nq):
            rows = keep[qt * BQ:(qt + 1) * BQ]
            kept = {(kt, cw) for kt in range(nk) for cw in range(NC)
                    if rows[:, kt * BKT + half * cw:
                            kt * BKT + half * (cw + 1)].any()}
            in_range = {(kt, cw) for kt in range(nk) for cw in range(NC)
                        if kt * BKT + half * cw < Sk}
            got = turns.get((bh, qt), [])
            assert sorted(got) == list(range(len(got))) and got
            assert parts[(bh, qt)] & in_range == kept
            assert (0, 0) in parts[(bh, qt)]
            kvh = bh // group
            for turn in (n for n in got if n > 0):
                kt, cw = divmod(turn, NC)
                if cw == 0:
                    assert ticket[(kvh, kt - 1)] < ticket[(kvh, kt)]
            assert len(step_of[(bh, qt)]) == 1


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,group,Sq,Sk", _ORDER_SHAPES[:3])
def test_fused_order_cannot_deadlock(BHkv, group, Sq, Sk, causal, slots):
    """The mirror's blocks run on ``slots`` resident places, started in
    ticket order as places free up; each block's two reducers add their
    steps in walk order when the tile's counter reads their turn, neither
    more than kStages + 1 steps ahead of the other (the ring and the
    staging tile): every block finishes, however few places there are."""
    run_fused_blocks(fused_schedule(BHkv, group, Sq, Sk, causal), slots)


def run_fused_blocks(blocks, slots):
    """:func:`test_fused_order_cannot_deadlock`'s run of the mirror's
    ``blocks`` on ``slots`` resident places; fails if none can move."""
    ahead = int(_consts()["kStages"]) + 1
    count, queue, running = {}, sorted(blocks), {}
    while queue or running:
        while queue and len(running) < slots:
            running[queue.pop(0)] = [0, 0]
        moved = False
        for t in list(running):
            _, kt, steps = blocks[t]
            pos = running[t]
            if pos == [len(steps)] * 2:
                del running[t]
                moved = True
                continue
            for cw in (0, 1):
                i = pos[cw]
                if i == len(steps) or i - pos[1 - cw] >= ahead:
                    continue
                bh, qt, _ = steps[i]
                if count.get((bh, qt), 0) == 2 * kt + cw:
                    count[(bh, qt)] = 2 * kt + cw + 1
                    pos[cw] += 1
                    moved = True
        assert moved, f"no block can move: {running}"


def test_fused_scratch_matches_the_source():
    """scratch_numel's fused layout is launch_fused's: lse2 and Dsum (2,
    BH, Sp), acc (BH, Sp, D) f32 (a 64 D-float tile per (head, 64-row
    query tile): FusedLayout's staging tile), one counter per tile and
    the ticket; the query tile is the source's and divides the row
    pad."""
    c = _consts()
    src = open(SRC).read()
    assert int(c["kDkdvBQ"]) == BK.FUSED_Q_TILE
    assert BK.ROW_PAD % BK.FUSED_Q_TILE == 0
    assert "kStageBytes = kBQ * D * 4" in src
    assert "const int n_count = BH * nq_acc;" in src
    assert re.search(r"acc \+ static_cast<long long>\(BH\) \*\s+Sp \* D",
                     src)
    assert "n_count + 1, BH, Sq, Sp)" in src
    for BH, Sq, D in ((4, 9, 64), (3, 257, 128), (128, 3904, 128),
                      (48, 1500, 64)):
        Sp = -(-Sq // BK.ROW_PAD) * BK.ROW_PAD
        tiles = BH * (Sp // BK.FUSED_Q_TILE)
        stage = BK.FUSED_Q_TILE * D
        assert BK.scratch_numel("fused", BH, Sq, D) == (
            BK.scratch_numel("wgmma", BH, Sq) + tiles * stage + tiles + 1)
        assert tiles * stage == BH * Sp * D


def test_c_entry_holds_the_fused_rule():
    """The C entry's fused test, its bf16-only condition (through
    ``tensor_cores``) and the instances it dispatches to are
    ``bwd_kernel.variant``'s: "fused" exactly where K6's rule names its
    tensor cores and (D, Dv) is in FUSED_HEAD_DIMS, K6's variant
    elsewhere."""
    src = open(SRC).read()
    test = re.search(r"const bool fused =(.*?);", src, re.S).group(1)
    assert re.match(r"\s*tensor_cores && D == Dv && \(", test)
    dims = {(int(d), int(d)) for d in re.findall(r"D == (\d+)", test)}
    assert dims == set(BK.FUSED_HEAD_DIMS)
    launched = {(int(d), int(d))
                for d in re.findall(r"return launch_fused<(\d+)>", src)}
    assert launched == dims
    assert BK.VARIANTS == {"simt": 0, "wgmma": 1, "fused": 2}
    for D in range(1, BK.MAX_HEAD_DIM + 1):
        for Dv in (D, 64, 128):
            k6 = AK.variant(torch.bfloat16, D, Dv)
            want = "fused" if (D, Dv) in dims else k6
            assert BK.variant(torch.bfloat16, D, Dv) == want
            assert BK.variant(torch.float32, D, Dv) == "simt"


@pytest.mark.parametrize("D,Dv,dtype,force,msg", [
    (64, 64, torch.bfloat16, "fused", "on the card"),
    (64, 64, torch.bfloat16, "wgmma", "on the card"),
    (128, 128, torch.bfloat16, "wgmma", "on the card"),
    (80, 80, torch.bfloat16, "fused", "fused kernels take bf16"),
    (192, 128, torch.bfloat16, "fused", "fused kernels take bf16"),
    (64, 64, torch.float32, "fused", "fused kernels take bf16"),
    (64, 64, torch.float32, "wgmma", "wgmma kernels take bf16")])
def test_bwd_forced_designs(D, Dv, dtype, force, msg):
    """A forced ``"fused"`` runs only where the rule names it; a forced
    ``"wgmma"`` (the three-kernel design) runs at every tensor-core head
    dim, (64, 64) and (128, 128) too; a refusal comes before anything is
    built or launched, and an accepted one reaches the device checks."""
    q = torch.zeros(4, 9, D, dtype=dtype)
    k = torch.zeros(2, 9, D, dtype=dtype)
    v = torch.zeros(2, 9, Dv, dtype=dtype)
    o = torch.zeros(4, 9, Dv, dtype=dtype)
    before = dict(BK.KERNEL.launches_by_variant)
    with pytest.raises(ValueError, match=msg):
        BK.flash_attention_bwd_cuda(q, k, v, o, torch.zeros(4, 9), o,
                                    group=2, force_variant=force)
    assert BK.KERNEL.launches_by_variant == before


@pytest.mark.parametrize("split_p,split_ds,seed,causal,group", [
    (False, True, 2, False, 1), (True, False, 5, True, 4)])
def test_one_bf16_rounding_breaks_the_bf16_rule(split_p, split_ds, seed,
                                                causal, group):
    """Why p and ds enter their products as hi and lo pairs: rounded to
    bf16 once, p (into dv; the full softmax, group 1) or ds (into dq and
    dk) puts the gradient more than 1.5x further from the f32 gradient
    than the plain bf16 gradient on these inputs, where the pairs hold
    it."""
    args, plain, f32 = _bf16_case(seed, 8, 256, 64, group, causal)
    ref = _grad_err(plain, f32)
    once = wgmma_model(*args, group=group, causal=causal, split_p=split_p,
                       split_ds=split_ds)
    pairs = wgmma_model(*args, group=group, causal=causal)
    assert _grad_err(once, f32) > 1.5 * ref
    assert _grad_err(pairs, f32) <= 1.5 * ref


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_wgmma_rounding_model_matches_jax_custom_vjp(causal, group):
    """The rounding model on bf16 inputs against the reference's
    ``_flash_core_bwd`` (``jax.vjp`` of ``chunked_attention``): no further
    from its f32 gradient than its own bf16 gradient is, x1.5."""
    _model_vs_jax(2, 128, 64, 64, 4 // group, group, causal,
                  11 + group + 2 * causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_wgmma_rounding_model_matches_jax_custom_vjp_at_mla_head_dims(
        causal, group):
    """As above at MLA's head dims (D = 192, Dv = 128, the reference's
    default scale 192 ** -0.5), over seeds, with the model fed the
    residuals (o, lse) of the reference's own forward, ``_flash_core_fwd``:
    backward against backward. The port's whole attention, its plain
    forward's o and lse then its plain backward, is held to the same rule
    on these seeds by
    :func:`test_port_bf16_attention_matches_jax_at_mla_head_dims`."""
    for seed in (17, 18):
        _model_vs_jax(2, 64, 192, 128, 2 // group, group, causal, seed,
                      jax_residuals=True)


@pytest.mark.parametrize("group", [1, 2])
def test_port_bf16_attention_matches_jax_at_mla_head_dims(group):
    """The port's whole bf16 attention at MLA's head dims (D = 192, Dv =
    128, the reference's scale 192 ** -0.5, causal): its own plain forward
    (o and lse, ``flash_attention_lse_ref``) and then its own plain
    backward (``flash_attention_bwd_ref``), against ``jax.vjp`` of the
    reference's ``chunked_attention``, on seeds 17 and 18: no further from
    JAX's f32 gradient than JAX's bf16 gradient is, x1.5. The plain
    forward rounds the normalised p to bf16 before p.v, where K6 and the
    reference round the unnormalised exp(s - rowmax); the ratios measured
    here (seed 17, 18) are 1.476, 1.000 at group 1 and 1.079, 1.038 at
    group 2, inside the rule, so the plain forward keeps its rounding."""
    for seed in (17, 18):
        ratio = _model_vs_jax(2, 64, 192, 128, 2 // group, group, True, seed,
                              backward=FR.flash_attention_bwd_ref)
        print(f"group {group} seed {seed}: the port's bf16 gradient is "
              f"{ratio:.3f} x JAX's bf16 distance from JAX's f32 one")


def _model_vs_jax(B, S, D, Dv, KH, group, causal, seed, jax_residuals=False,
                  backward=None):
    """The rounding model (or ``backward``, a function of K7's signature)
    on bf16 inputs (q, k of head dim D, v, do of Dv) against ``jax.vjp`` of
    the reference's ``chunked_attention`` in f32 and in bf16: no further
    from JAX's f32 gradient than JAX's bf16 gradient is, x1.5. o and lse:
    the port's plain forward's, or with ``jax_residuals`` those
    ``_flash_core_fwd`` saves for its backward."""
    H = KH * group
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(shape).astype(np.float32)
         for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, Dv),
                       (B, S, H, Dv))]
    x = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
         for a in x]                              # bf16-representable
    f = lambda q_, k_, v_: JA.chunked_attention(
        q_, k_, v_, causal=causal, q_chunk=64, kv_chunk=64)

    def grads(dtype):
        args = [jnp.asarray(a, dtype) for a in x]
        _, vjp = jax.vjp(f, *args[:3])
        return [np.asarray(g.astype(jnp.float32)) for g in vjp(args[3])]

    jax32, jax16 = grads(jnp.float32), grads(jnp.bfloat16)
    tq, tk, tv, tdo = (_flat(a, B, S, n).to(torch.bfloat16)
                       for a, n in zip(x, (H, KH, KH, H)))
    o, lse = FR.flash_attention_lse_ref(tq, tk, tv, group=group,
                                        causal=causal)
    if jax_residuals:
        a = [jnp.asarray(t, jnp.bfloat16) for t in x[:3]]
        _, (*_, oj, lj) = JA._flash_core_fwd(
            a[0].reshape(B, S, KH, group, D), a[1], a[2], causal, 0, 64, 64,
            D ** -0.5)                        # (B, KH, G, S, Dv), (.., S)
        o = torch.from_numpy(np.asarray(oj.astype(jnp.float32)).reshape(
            B * H, S, Dv)).to(torch.bfloat16)
        lse = torch.from_numpy(np.asarray(lj, np.float32).reshape(B * H, S))
    got = (backward or wgmma_model)(tq, tk, tv, o, lse, tdo, group=group,
                                    causal=causal)
    unflat = lambda t, n: t.float().reshape(B, n, S, -1).transpose(1, 2)
    got = [unflat(g, n).numpy() for g, n in zip(got, (H, KH, KH))]

    def err(a, b):
        return max(float(np.abs(u - w).max()) / float(np.abs(w).max())
                   for u, w in zip(a, b))
    ratio = err(got, jax32) / err(jax16, jax32)
    assert ratio <= 1.5
    return ratio
