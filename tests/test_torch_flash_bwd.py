"""The gradient of the port's flash attention on the CPU:
``ref.flash_attention_bwd_ref`` (the plain version of K7) against
``jax.vjp`` of the reference's ``chunked_attention`` (its ``custom_vjp``
backward, ``_flash_core_bwd``) and against torch autograd through the
plain forward; ``ops.FlashAttention`` under ``gradcheck`` in f64; the
forward's logsumexp.

Inputs are drawn with numpy and handed to both packages, in the
reference's (B, S, H, D) layout, flattened to (B*H, S, D) as the port's
``models.attention.chunked_attention`` does. f32 tolerance 1e-5 of each
gradient's largest element (the reference sums over chunk pairs, the
plain version over whole rows).
"""
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
