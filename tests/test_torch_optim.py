"""The port's AdamW and LR schedule against the JAX package on the CPU.

Inputs are drawn with numpy and handed to both. Tolerances: parameters
and moments within 1e-6 of each leaf's largest element after 3 updates
(the same f32 elementwise arithmetic; the global norm sums in another
order); ``lr_at`` within 1e-6 relative at every step of a schedule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import adamw as JADAMW
from repro.optim.schedule import lr_at as jax_lr_at
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at

SHAPES = {"a": (7, 5), "b": {"c": (300,), "d": (4, 3, 2)}, "e": ()}


def _tree(rng, scale=1.0, dtype=np.float32):
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return np.asarray(rng.standard_normal(node) * scale, dtype)
    return rec(SHAPES)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _close(got, want, tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
        return
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_matches_jax(rng, state_dtype, inplace):
    """Three updates with clipping active (grad_clip 0.5 against norms
    near 20), decay on, lr a 0-d value: params, mu, nu, step and gnorm."""
    kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=0.5)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    p = _tree(rng)
    jp = _map(jnp.asarray, p)
    tp = _map(torch.from_numpy, p)
    jo = JADAMW.init(jp, jcfg, state_dtype)
    to = adamw.init(tp, tcfg, state_dtype)
    assert to.mu["a"].dtype == getattr(torch, state_dtype)
    for i in range(3):
        g = _tree(rng, scale=2.0)
        lr = 1e-2 * (i + 1) / 3
        jp, jo, jn = JADAMW.apply(jp, _map(jnp.asarray, g), jo, jcfg,
                                  jnp.asarray(lr, jnp.float32))
        tp, to, tn = adamw.apply(tp, _map(torch.from_numpy, g), to, tcfg,
                                 torch.tensor(lr), inplace=inplace)
        assert float(tn) > 10 * kw["grad_clip"]           # clipping on
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to.step) == int(jo.step) == i + 1
        _close(tp, jp, 1e-6)
        _close(to.mu, jo.mu, 1e-6)
        _close(to.nu, jo.nu, 1e-6)


def test_adamw_slices_change_no_value(rng, monkeypatch):
    """The update in slices of CHUNK elements equals the whole-leaf one."""
    tcfg = TrainConfig(grad_clip=1e9)
    p = {"w": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))}
    whole = adamw.apply(p, g, adamw.init(p, tcfg), tcfg, 0.1)
    monkeypatch.setattr(adamw, "CHUNK", 64)
    sliced = adamw.apply(p, g, adamw.init(p, tcfg), tcfg, 0.1)
    for a, b in ((whole[0]["w"], sliced[0]["w"]),
                 (whole[1].mu["w"], sliced[1].mu["w"]),
                 (whole[1].nu["w"], sliced[1].nu["w"])):
        assert torch.equal(a, b)


def test_clip_by_global_norm_matches_jax():
    g = {"a": np.full((4,), 100.0, np.float32),
         "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jc, jn = JADAMW.clip_by_global_norm(_map(jnp.asarray, g), 1.0)
    tc, tn = adamw.clip_by_global_norm(_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tc, jc, 1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (7, 7),
                                          (3, 40)])
def test_lr_at_matches_jax_over_the_schedule(warmup, total):
    """Every step of the schedule and past its end, as an int and as a 0-d
    tensor."""
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    for step in range(total + 5):
        want = float(jax_lr_at(step, jcfg))
        got = lr_at(step, tcfg)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
        t = lr_at(torch.tensor(step, dtype=torch.int32), tcfg)
        assert t.dtype == torch.float32 and t.shape == ()
        assert float(t) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_opt_state_checkpoints_as_itself(tmp_path, rng):
    """``OptState`` is registered with the port's checkpoints: a restored
    state is an ``OptState`` again, bf16 moments included."""
    tcfg = TrainConfig()
    p = _map(torch.from_numpy, _tree(rng))
    opt = adamw.init(p, tcfg, "bfloat16")
    CKPT.save({"opt": opt}, str(tmp_path), 3)
    back, step = CKPT.restore(str(tmp_path), device="cpu")
    assert step == 3 and isinstance(back["opt"], adamw.OptState)
    assert back["opt"].mu["b"]["c"].dtype == torch.bfloat16
    assert back["opt"].step.dtype == torch.int32


def test_adamw_converges_on_a_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw.init(params, tcfg)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw.apply(params, g, opt, tcfg,
                                     lr_at(opt.step, tcfg))
    torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)
