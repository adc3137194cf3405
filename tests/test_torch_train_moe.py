"""The port's training loss of the moe family (deepseek-v3 with MLA and
multi-token prediction, llama4-scout) and of the qwen and granite-20b
configs against the JAX package on the CPU, at REDUCED width in f32.

The reference's parameters cross as numpy (``torch_cross.cross``), with
every all-zero / all-one leaf (norm scales, qkv biases, the sigmoid
router's bias) perturbed first so that a port which drops one shows.
The batches are the reference's ``data.tokens`` batches, fed to both.
JAX's loss and gradient are jitted once per case in a module-scoped
cache (its expert layer runs under ``shard_map``, which costs seconds a
call eagerly). Tolerances, f32: the loss 1e-5 relative and every
gradient leaf 1e-4 of its largest element (the same arithmetic summed in
another order); after a train step, parameters within 1e-3 of the
learning rate and the moments within 1e-4 of their largest element of
the reference's AdamW applied to the port's own gradients
(``torch_cross.hold_step``). The moe family is held in f32 only: a
bf16 rounding moves tokens between experts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import tokens as JDATA
from repro.launch import steps as JST
from repro.models.lm import lm_loss as jax_lm_loss
from repro.optim import adamw as JADAMW
from repro.optim.schedule import lr_at as jax_lr_at
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import moe as M
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from torch_cross import (assert_tree_close, cross, hold_step, leaves,
                         spy_on_apply)

B, S = 2, 24
DEEPSEEK, LLAMA4 = "deepseek-v3-671b", "llama4-scout-17b-a16e"
# case id -> (arch, MoE sub-config changes, config changes)
CASES = {
    "deepseek-v3-mtp": (DEEPSEEK, None, {}),
    "deepseek-v3-no-mtp": (DEEPSEEK, None, {"mtp_depth": 0}),
    "deepseek-v3-mtp-cf0.5": (DEEPSEEK, {"capacity_factor": 0.5}, {}),
    "llama4-scout": (LLAMA4, None, {}),
    "qwen3-14b": ("qwen3-14b", None, {}),
    "qwen1.5-32b": ("qwen1.5-32b", None, {}),
    "granite-20b": ("granite-20b", None, {}),
}


@pytest.fixture(scope="module")
def models(mesh):
    """case id -> (JAX model, its params, the port's Model, the same
    params), each built once."""
    built = {}

    def get(case):
        if case not in built:
            arch, moe, changes = CASES[case]
            built[case] = cross(arch, "float32", mesh, moe=moe, **changes)
        return built[case]
    return get


def _batch(cfg, step=0):
    """The reference's batch, as JAX arrays and as torch tensors."""
    jb = JDATA.batch_at(step, cfg, B, S, seed=0)
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k != "mask" else np.float32)) for k, v in jb.items()}
    return jb, tb


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(models, mesh, case):
    """The loss (with the MTP loss at 0.3 where the config has one) and
    every gradient leaf against ``jax.value_and_grad`` of the reference's
    ``lm_loss``; the sigmoid router's bias, which steers only top-k's
    indices, gets a zero gradient in both. Under top-1 routing
    (llama4-scout) the renormalised weight is s / s = 1, so the router's
    gradient is 0 up to rounding in both packages: that leaf is held to
    1e-4 of the tree's largest gradient element instead of its own."""
    jm, jp, tm, tp = models(case)
    jb, tb = _batch(jm.cfg)
    with mesh:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jax_lm_loss(p, b, jm.cfg, mesh, ())))(jp, jb)
    tl, tg = ST.loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    top1 = tm.cfg.moe is not None and tm.cfg.moe.top_k == 1
    assert_tree_close(tg, jg, 1e-4, what=f"{case} grad", global_for=[
        p for p in leaves(tg) if top1 and p[-1] == "router"])
    assert ("mtp" in tg) == bool(tm.cfg.mtp_depth)
    for path, g in leaves(tg).items():
        if path[-1] == "bias" and "moe" in path:
            assert not g.any(), path
    if case.endswith("cf0.5"):
        with torch.no_grad():
            drops = M.drops_of(lambda: tm.loss(tp, tb))
        assert sum(d for d, _ in drops) > 0


@pytest.mark.parametrize("case", ["deepseek-v3-mtp", "llama4-scout"])
def test_remat_equals_no_remat(models, case):
    """Under ``remat="full"`` the backward recomputes each block of the
    stacks; the recomputed expert layers drop the same pairs (C is
    static, the sort stable), so the loss and every gradient equal the
    stored-activation run's bit for bit."""
    _, _, tm, tp = models(case)
    _, tb = _batch(tm.cfg, step=3)
    runs = [ST.loss_and_grads(Model(tm.cfg.replace(remat=r), device="cpu"),
                              tp, tb) for r in ("none", "full")]
    assert float(runs[0][0]) == float(runs[1][0])
    for path, g in leaves(runs[0][1]).items():
        assert torch.equal(g, leaves(runs[1][1])[path]), path


def test_only_the_router_bias_may_go_unreached():
    """``loss_and_grads`` gives the sigmoid router's ``bias`` and an empty
    leaf (a stack cut to 0 layers), which the loss does not reach, a zero
    gradient, and raises for any other leaf the loss does not reach."""
    class Stub:
        def loss(self, params, batch):
            return (params["w"] * batch).sum()

    x = torch.arange(3.0)
    ok = {"w": torch.ones(3), "moe": {"bias": torch.ones(3)},
          "stack": {"w": torch.ones(0, 3)}}
    loss, grads = ST.loss_and_grads(Stub(), ok, x)
    assert float(loss) == 3.0 and torch.equal(grads["w"], x)
    assert torch.equal(grads["moe"]["bias"], torch.zeros(3))
    assert grads["stack"]["w"].shape == (0, 3)
    with pytest.raises(RuntimeError, match="attn/bias"):
        ST.loss_and_grads(Stub(), {**ok, "attn": {"bias": torch.ones(3)}}, x)


def test_train_step_matches_jax(models, mesh, monkeypatch):
    """Two deepseek-v3 train steps (MLA, MoE, MTP) from the same weights
    and batches (warmup 1, so the first step's lr is 0 and the second's
    the peak): loss, gnorm, lr, mu and nu against the reference's
    ``make_train_step``; the gradients the port's step used against the
    reference's at the same parameters, and every parameter, mu and nu
    against the reference's AdamW on those gradients
    (``torch_cross.hold_step``). AdamW's eps is 1e-6: an expert that
    few tokens reach has gradient elements near 1e-8, whose f32 rounding
    differs between the packages by about 1e-3 of themselves, and at
    eps = 1e-8 Adam scales each such element to a step of about lr, so
    the parameters would differ by about 1e-3 lr; at 1e-6 such an
    element's step is small and the comparison measures the port."""
    jm, jp, tm, tp = models("deepseek-v3-mtp")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
    jstep = jax.jit(JST.make_train_step(jm, JTrainConfig(**kw)))
    tcfg = TrainConfig(**kw)
    japply = jax.jit(lambda p, g, o: JADAMW.apply(
        p, g, o, JTrainConfig(**kw), jax_lr_at(o.step, JTrainConfig(**kw))))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, b, jm.cfg, mesh, ())))
    seen = spy_on_apply(monkeypatch)
    tstep = ST.make_train_step(tm, tcfg)
    jstate = {"params": jp, "opt": JADAMW.init(jp, JTrainConfig(**kw))}
    tstate = {"params": adamw.tree_map(torch.clone, tp),
              "opt": adamw.init(tp, tcfg)}
    for step in range(2):
        jb, tb = _batch(jm.cfg, step=step)
        with mesh:
            jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["gnorm"]),
                                   float(jmet["gnorm"]), rtol=1e-4)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
        with mesh:
            hold_step(tstate, seen[-1], japply, lambda p: vg(p, jb)[1],
                      1e-4, kw["learning_rate"], what=f"step {step}")
        assert_tree_close(tstate["opt"].mu, jstate["opt"].mu, 1e-4,
                           what="mu")
        assert_tree_close(tstate["opt"].nu, jstate["opt"].nu, 1e-4,
                           what="nu")


def test_bf16_moments_follow_the_config(models):
    """deepseek-v3's full config keeps its AdamW moments in bf16, as the
    reference's does: ``init_train_state`` makes them in
    ``cfg.opt_state_dtype``, and a step with them gives the f32-moment
    step's moments rounded to bf16 (within one bf16 step of each leaf's
    largest element) and the same parameters to 1e-2 of the learning
    rate."""
    assert get_config(DEEPSEEK).opt_state_dtype == "bfloat16"
    _, _, tm, tp = models("deepseek-v3-no-mtp")
    _, tb = _batch(tm.cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                       donate_state=False)
    out = {}
    for dt in ("float32", "bfloat16"):
        model = Model(tm.cfg.replace(opt_state_dtype=dt), device="cpu")
        state = ST.init_train_state(model, tcfg, 0)
        assert all(t.dtype == getattr(torch, dt)
                   for t in adamw.leaves(state["opt"].mu))
        state = {"params": tp, "opt": adamw.init(tp, tcfg, dt)}
        out[dt], _ = ST.make_train_step(model, tcfg)(state, tb)
    for name in ("mu", "nu"):
        f32 = getattr(out["float32"]["opt"], name)
        b16 = getattr(out["bfloat16"]["opt"], name)
        for a, b in zip(adamw.leaves(b16), adamw.leaves(f32)):
            assert a.dtype == torch.bfloat16
            assert float((a.float() - b).abs().max()) <= \
                2.0 ** -7 * float(b.abs().max())
    for a, b in zip(adamw.leaves(out["bfloat16"]["params"]),
                    adamw.leaves(out["float32"]["params"])):
        assert float((a - b).abs().max()) <= 1e-2 * tcfg.learning_rate


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_train_main_runs_the_moe_family(tmp_path, arch):
    """``python -m repro_torch.launch.train --arch <moe id> --reduced
    --device cpu``: finite losses that fall over 12 steps at a high
    learning rate, and a checkpoint whose moments are in the config's
    dtype."""
    from repro_torch.checkpoint import checkpoint as CKPT
    losses = TR.main(["--arch", arch, "--reduced", "--batch", "2", "--seq",
                      "32", "--steps", "12", "--lr", "3e-3", "--device",
                      "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                      "100", "--log-every", "100"])
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    state, step = CKPT.restore(str(tmp_path), device="cpu")
    dt = getattr(torch, get_config(arch, reduced=True).opt_state_dtype)
    assert step == 12 and all(t.dtype == dt for t in
                              adamw.leaves(state["opt"].mu))
