"""The port's expert layer (``models/moe.py``) against the JAX package on
the CPU, on the (1, 1) mesh.

Routing indices must be equal and weights agree to 1e-6; the experts'
outputs to 1e-6 (one share) and 1e-5 (the whole layer) in f32. In bf16,
with inputs crossed bit for bit, the selected experts must be equal and
the output within 1e-2 of its largest entry (the frameworks round the
expert products and the scatter-add at other places). Zero-initialised
router biases are replaced by numpy draws so that they count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from torch_cross import close, configs, to_np

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _configs(arch, **moe_changes):
    """(reference config, port config) of ``arch`` at REDUCED in f32 with
    ``moe_changes`` applied to both MoE sub-configs."""
    return configs(arch, "float32", moe=moe_changes)


def _params(rng, d, E, f, dtype="float32", shared=True, bias=True):
    """Expert-layer parameters as numpy, rounded to ``dtype`` by JAX (and
    returned as f32 arrays that hold those values exactly)."""
    def r(*shape, s=0.3):
        a = rng.standard_normal(shape).astype(np.float32) * s
        return np.asarray(jnp.asarray(a, JDT[dtype]), np.float32)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "gate": r(E, d, f), "up": r(E, d, f), "down": r(E, f, d)}
    if bias:
        p["bias"] = rng.standard_normal(E).astype(np.float32) * 0.3
    if shared:
        p["shared"] = {"gate": {"w": r(d, f)}, "up": {"w": r(d, f)},
                       "down": {"w": r(f, d)}}
    return p


def _both(p, dtype="float32"):
    """A numpy tree as (JAX tree, torch tree); the router and its bias stay
    f32 as in both packages' descs."""
    def rec(node, name=""):
        if isinstance(node, dict):
            return [dict(zip(node, v)) for v in zip(*(
                rec(node[k], k) for k in node))] if node else [{}, {}]
        dt = "float32" if name in ("router", "bias") else dtype
        return (jnp.asarray(node, JDT[dt]),
                torch.from_numpy(np.array(node, np.float32)).to(
                    getattr(torch, dt)))
    return rec(p)


@pytest.mark.parametrize("arch,score", [("llama4-scout-17b-a16e", "softmax"),
                                        ("deepseek-v3-671b", "sigmoid")])
def test_route_matches_jax(rng, arch, score):
    """Softmax routing, and sigmoid routing whose bias steers only the
    selection (deepseek-v3, with its routed scaling factor 2.5)."""
    jc, tc = _configs(arch, score_func=score, top_k=2, num_experts=8)
    d = jc.d_model
    p = _params(rng, d, 8, 4, shared=False, bias=score == "sigmoid")
    x = rng.standard_normal((50, d)).astype(np.float32)
    jp, tp = _both(p)
    wj, ij = JM.route(jp, jnp.asarray(x), jc)
    wt, it = TM.route(tp, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(wt, wj, 1e-6)
    if score == "sigmoid":     # the bias changed some selections
        _, unbiased = TM.route(dict(tp, bias=torch.zeros(8)),
                               torch.from_numpy(x), tc)
        assert not torch.equal(unbiased, it)


def test_expert_share_matches_jax(rng):
    """One expert-parallel rank's share, E_loc = E / 4 experts from
    my_first = E / 2, against the reference's function: only the pairs
    routed there contribute, a quarter of them over capacity."""
    E, d, f, T, k = 8, 16, 12, 30, 2
    p = _params(rng, d, E, f, shared=False, bias=False)
    x = rng.standard_normal((T, d)).astype(np.float32)
    e = rng.integers(0, E, T * k).astype(np.int32)
    w = rng.random(T * k).astype(np.float32)
    E_loc, first, C = E // 4, E // 2, 4
    loc = {n: p[n][first:first + E_loc] for n in ("gate", "up", "down")}
    jl, tl = _both(loc)
    want = JM._expert_gather_compute(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(e), jl, E_loc, C, first)
    got = TM._expert_gather_compute(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(e.astype(np.int64)), tl,
                                    E_loc, C, first)
    close(got, want, 1e-6)
    mine = (e >= first) & (e < first + E_loc)
    assert np.bincount(e[mine] - first).max() > C     # some were dropped
    untouched = ~np.isin(np.arange(T), np.flatnonzero(mine) // k)
    assert untouched.any() and not got[untouched].any()


@pytest.mark.parametrize("arch,cf,B,S", [
    ("deepseek-v3-671b", 2.0, 2, 9),      # REDUCED's factor
    ("deepseek-v3-671b", 0.5, 2, 9),      # over capacity: pairs dropped
    ("llama4-scout-17b-a16e", 2.0, 3, 5),
    ("llama4-scout-17b-a16e", 0.5, 3, 5),
    ("deepseek-v3-671b", 1.25, 4, 1),     # a decode step's 4 tokens
])
def test_moe_ffn_matches_jax(rng, mesh, arch, cf, B, S):
    jc, tc = _configs(arch, capacity_factor=cf)
    m = tc.moe
    p = _params(rng, tc.d_model, m.num_experts, m.d_ff_expert,
                bias=m.score_func == "sigmoid")
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    jp, tp = _both(p)
    with mesh:
        want = jax.jit(lambda p, x: JM.moe_ffn(p, x, jc, mesh, ("data",)))(
            jp, jnp.asarray(x))
    got = TM.moe_ffn(tp, torch.from_numpy(x), tc)
    assert got.shape == x.shape
    close(got, want, 1e-5)
    C = TM.capacity(tc, B * S)
    _, idx = TM.route(tp, torch.from_numpy(x.reshape(B * S, -1)), tc)
    dropped = int((torch.bincount(idx.reshape(-1), minlength=m.num_experts)
                   - C).clamp(min=0).sum())
    if cf < 1.0:
        assert dropped > 0, C


def test_moe_ffn_bf16_selects_the_same_experts(rng, mesh):
    """bf16 inputs and weights crossed bit for bit: the same experts, the
    output within 1e-2 of its largest entry."""
    jc, tc = _configs("deepseek-v3-671b")
    jc = jc.replace(dtype="bfloat16", param_dtype="bfloat16")
    tc = tc.replace(dtype="bfloat16", param_dtype="bfloat16")
    m = tc.moe
    p = _params(rng, tc.d_model, m.num_experts, m.d_ff_expert, "bfloat16")
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 16, tc.d_model)),
                               jnp.bfloat16), np.float32)
    jp, tp = _both(p, "bfloat16")
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    _, ij = JM.route(jp, xj.reshape(32, -1), jc)
    _, it = TM.route(tp, xt.reshape(32, -1), tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    with mesh:
        want = to_np(jax.jit(lambda p, x: JM.moe_ffn(
            p, x, jc, mesh, ("data",)))(jp, xj))
    got = TM.moe_ffn(tp, xt, tc)
    assert got.dtype == torch.bfloat16
    assert np.abs(to_np(got) - want).max() <= 1e-2 * np.abs(want).max()


def test_capacity_is_the_references_on_one_device():
    """C = max(1, ceil(T top_k capacity_factor / E)): deepseek-v3 serves
    4 x 1024-token prompts at 160 slots per expert and decodes 4 tokens at
    1."""
    cfg = get_config("deepseek-v3-671b")
    assert TM.capacity(cfg, 4 * 1024) == 160
    assert TM.capacity(cfg, 4) == 1
    assert TM.capacity(get_config("llama4-scout-17b-a16e"), 4096) == 320


def test_load_balance_loss_matches_jax(rng):
    jc, tc = _configs("llama4-scout-17b-a16e")
    p = _params(rng, tc.d_model, tc.moe.num_experts, 4, shared=False,
                bias=False)
    x = rng.standard_normal((3, 7, tc.d_model)).astype(np.float32)
    jp, tp = _both(p)
    want = JM.load_balance_loss(jp, jnp.asarray(x), jc)
    got = TM.load_balance_loss(tp, torch.from_numpy(x), tc)
    assert got.shape == () and float(got) >= 1.0 - 1e-6
    close(got, want, 1e-6)
