"""The port's training path against the JAX package on the CPU, at REDUCED
granite width (2 layers, d 64, 4/2 heads of 16, vocab 256) in f32.

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.cross``, crossed by ``convert.lm_params_from_numpy``); the
batches are the
reference's ``data.tokens`` batches, fed to both (the port's own token
draws come from a ``torch.Generator``). Tolerances, f32: the loss 1e-5
and every gradient leaf 1e-4 of its largest element (the same arithmetic
summed in another order; attention's backward recomputes p from lse);
after a train step, parameters within 1e-3 of the learning rate and the
moments within 1e-4 of their largest element of the reference's AdamW
applied to the port's own gradients (``torch_cross.hold_step``).
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
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import tokens as DATA
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import lm as LM
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from torch_cross import assert_tree_close, cross, hold_step, spy_on_apply

ARCH = "granite-3-2b"
B, S = 4, 32


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (JAX or torch)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def ref(mesh):
    """(JAX model, its f32 params, the port's Model, the same params)."""
    return cross(ARCH, "float32", mesh)


def _batch(cfg, step=0, b=B, s=S):
    """The reference's batch, as JAX arrays and as torch tensors."""
    jb = JDATA.batch_at(step, cfg, b, s, seed=0)
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k != "mask" else np.float32)) for k, v in jb.items()}
    return jb, tb


def test_lm_loss_and_grads_match_jax(ref, mesh):
    jm, jp, tm, tp = ref
    jb, tb = _batch(jm.cfg)
    with mesh:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jax_lm_loss(p, b, jm.cfg, mesh, ())))(jp, jb)
    tl, tg = ST.loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_tree_close(tg, jg, 1e-4, what="grad")
    assert float(tm.loss(tp, tb)) == pytest.approx(float(tl), rel=1e-7)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_equals_no_remat(ref, remat):
    """``remat="full"`` recomputes each block in the backward; the loss
    and every gradient equal the stored-activation run's."""
    _, _, tm, tp = ref
    _, tb = _batch(tm.cfg, step=3)
    base = Model(tm.cfg.replace(remat="none"), device="cpu")
    other = Model(tm.cfg.replace(remat=remat), device="cpu")
    la, ga = ST.loss_and_grads(base, tp, tb)
    lb, gb = ST.loss_and_grads(other, tp, tb)
    assert float(la) == float(lb)
    for path, g in _flat(ga).items():
        assert torch.equal(g, _flat(gb)[path]), path


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(ref, mesh, accum, monkeypatch):
    """Two train steps from the same weights and batches (warmup 1, so
    the first step's lr is 0 and the second's is the peak): loss, gnorm,
    lr, mu and nu against the reference's ``make_train_step``; the
    gradients the port's step used (the mean of ``accum`` micro-batches')
    against the reference's at the same parameters, and every parameter,
    mu and nu against the reference's AdamW on those gradients
    (``torch_cross.hold_step``)."""
    jm, jp, tm, tp = ref
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              grad_accum=accum)
    jstep = jax.jit(JST.make_train_step(jm, JTrainConfig(**kw)))
    tcfg = TrainConfig(**kw)
    japply = jax.jit(lambda p, g, o: JADAMW.apply(
        p, g, o, JTrainConfig(**kw), jax_lr_at(o.step, JTrainConfig(**kw))))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, b, jm.cfg, mesh, ())))

    def ref_grads(p, jb):
        """The reference step's gradient at p: the mean over the
        micro-batches, summed in f32 as its scan sums them."""
        n = B // accum
        with mesh:
            gs = [vg(p, {k: v[i * n:(i + 1) * n] for k, v in jb.items()})[1]
                  for i in range(accum)]
        return jax.tree.map(lambda *g: sum(g) / accum, *gs)

    seen = spy_on_apply(monkeypatch)
    tstep = ST.make_train_step(tm, tcfg)
    jstate = {"params": jp, "opt": JADAMW.init(jp, JTrainConfig(**kw))}
    tstate = {"params": adamw.tree_map(torch.clone, tp),
              "opt": adamw.init(tp, tcfg)}
    for step in range(2):
        jb, tb = _batch(jm.cfg, step=step)
        with mesh:
            jstate, jm_ = jstep(jstate, jb)
        tstate, tm_ = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm_["gnorm"]), float(jm_["gnorm"]),
                                   rtol=1e-4)
        assert float(tm_["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)
        assert int(tstate["opt"].step) == int(jstate["opt"].step) == step + 1
        hold_step(tstate, seen[-1], japply, lambda p: ref_grads(p, jb),
                  1e-4, kw["learning_rate"], what=f"step {step}")
        assert_tree_close(tstate["opt"].mu, jstate["opt"].mu, 1e-4,
                           what="mu")
        assert_tree_close(tstate["opt"].nu, jstate["opt"].nu, 1e-4,
                           what="nu")


def test_donated_step_updates_in_place(ref):
    """``donate_state`` (the default) writes the new parameters and
    moments into the input state's tensors; without it they are new
    tensors and the input is untouched; both give the same values."""
    _, _, tm, tp = ref
    _, tb = _batch(tm.cfg)
    out = {}
    for donate in (True, False):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           donate_state=donate)
        state = {"params": adamw.tree_map(torch.clone, tp),
                 "opt": adamw.init(tp, tcfg)}
        w = state["params"]["final_norm"]["scale"]
        before = w.clone()
        new, _ = ST.make_train_step(tm, tcfg)(state, tb)
        assert (new["params"]["final_norm"]["scale"] is w) == donate
        assert torch.equal(w, before) != donate
        out[donate] = new
    for path, t in _flat(out[True]["params"]).items():
        assert torch.equal(t, _flat(out[False]["params"])[path]), path


def test_train_main_loss_falls_and_resume_is_exact(tmp_path, capsys):
    """``train.main`` on the CPU: the loss falls over 30 steps; 10 steps,
    then a resume to 20, equal 20 straight (step-keyed data, exact
    checkpoints); the optimizer state comes back as an ``OptState``."""
    common = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "64",
              "--device", "cpu", "--log-every", "100"]
    losses = TR.main(common + ["--steps", "30", "--lr", "3e-3",
                               "--ckpt-dir", str(tmp_path / "a"),
                               "--ckpt-every", "100"])
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    sched = ["--schedule-steps", "20", "--warmup", "2"]
    d1 = str(tmp_path / "run1")
    TR.main(common + sched + ["--steps", "10", "--ckpt-dir", d1,
                              "--ckpt-every", "10"])
    state, step = CKPT.restore(d1, device="cpu")
    assert step == 10 and isinstance(state["opt"], adamw.OptState)
    assert int(state["opt"].step) == 10
    resumed = TR.main(common + sched + ["--steps", "20", "--ckpt-dir", d1,
                                        "--ckpt-every", "100", "--resume"])
    straight = TR.main(common + sched + ["--steps", "20", "--ckpt-dir",
                                         str(tmp_path / "run2"),
                                         "--ckpt-every", "100"])
    assert "resumed from step 10" in capsys.readouterr().out
    assert resumed == straight[10:]


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch):
    """A SIGTERM during step 3 makes ``train.main`` checkpoint after that
    step and return; the handler it replaced is back afterwards, and a
    resume goes on from step 4."""
    import os
    import signal
    from repro_torch.distributed.monitor import StepMonitor
    stop = StepMonitor.stop
    calls = []

    def stop_and_signal(self):
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return stop(self)

    monkeypatch.setattr(StepMonitor, "stop", stop_and_signal)
    before = signal.getsignal(signal.SIGTERM)
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "100", "--log-every", "100"]
    losses = TR.main(args + ["--steps", "10"])
    assert len(losses) == 4 and CKPT.latest_step(str(tmp_path)) == 4
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.setattr(StepMonitor, "stop", stop)
    assert len(TR.main(args + ["--steps", "6", "--resume"])) == 2


def test_token_batches_follow_the_reference_recipe():
    """Step-keyed (same step, same batch; another step, another batch),
    the motif on every position with (pos // 8) % 4 == 0, targets the
    next tokens, and the dense family's modality stub is the identity."""
    cfg = get_config(ARCH, reduced=True)
    a, b = DATA.batch_at(5, cfg, 3, 70), DATA.batch_at(5, cfg, 3, 70)
    c = DATA.batch_at(6, cfg, 3, 70)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    full = torch.cat([a["tokens"], a["targets"][:, -1:]], 1)
    assert torch.equal(a["targets"], full[:, 1:])
    pos = torch.arange(71)
    motif_pos = pos[(pos // 8) % 4 == 0]
    for row in full:
        m = row[motif_pos]
        assert torch.equal(m, row[motif_pos % 8][:len(m)])
    assert int(full.max()) < cfg.vocab_size and int(full.min()) >= 0
    assert torch.equal(a["mask"], torch.ones(3, 70))
    assert DATA.add_modality_stub(a, cfg, 5) is a
    llava = get_config("llava-next-mistral-7b", reduced=True)
    patches = DATA.add_modality_stub(dict(a), llava, 5)["patches"]
    assert tuple(patches.shape) == (3, llava.vision.num_patches,
                                    llava.d_model)


def test_training_refusals():
    """What training still refuses (gradient compression in the train
    step: a one-card step has no data-parallel reduction, and the
    reference's step never reads the field), and what it no longer does:
    the moe family's loss and multi-token prediction run (they are held
    against JAX in tests/test_torch_train_moe.py), the vlm family's loss
    is ``lm_loss`` (tests/test_torch_vlm.py), and so do the hybrid, ssm
    and encdec families' through ``Model`` (tests/test_torch_hybrid.py,
    test_torch_rwkv.py, test_torch_whisper.py); ``lm_loss`` stays the
    dense, vlm and moe families' and refuses the rest."""
    with pytest.raises(NotImplementedError,
                       match="no data-parallel reduction") as err:
        TrainConfig(grad_compression="int8_ef")
    assert "optim.compression" in str(err.value)
    assert "not ported" not in str(err.value)
    cfg = get_config(ARCH, reduced=True)
    for family in ("hybrid", "ssm", "encdec"):
        with pytest.raises(NotImplementedError, match="through Model"):
            LM.lm_loss({}, {}, cfg.replace(family=family))
    llava = get_config("llava-next-mistral-7b", reduced=True)
    assert Model(llava, device="cpu").cfg.family == "vlm"
    tokens = torch.randint(0, 256, (2, 8), generator=torch.Generator()
                           .manual_seed(0))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    for moe_cfg in (get_config("deepseek-v3-671b", reduced=True),
                    get_config("deepseek-v3-671b", reduced=True)
                    .replace(mtp_depth=0)):
        model = Model(moe_cfg, device="cpu")
        loss = LM.lm_loss(model.init(0), batch, moe_cfg)
        assert loss.shape == () and bool(torch.isfinite(loss))
    assert cfg.remat == "none" and get_config(ARCH).remat == "full"
    assert (cfg.loss_chunk, cfg.opt_state_dtype) == (2048, "float32")


def test_cpu_training_launches_no_kernel(ref):
    """On CPU tensors the loss's attention runs the plain versions (its
    gradient too) and no kernel counts a launch."""
    _, _, tm, tp = ref
    _, tb = _batch(tm.cfg)
    AK.KERNEL.reset_counts()
    ST.loss_and_grads(tm, tp, tb)
    assert AK.KERNEL.launches == 0
