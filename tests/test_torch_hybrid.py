"""The port's hybrid family (zamba2-2.7b: a Mamba2 trunk with two shared
attention + FFN blocks) against the JAX package on the CPU, at REDUCED
width (4 layers, attn_every 2, d 64, SSM head 16, state 16, chunk 32), on
the (1, 1) mesh.

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.numpy_params``, the unit leaves perturbed: the norm
scales, D, A_log, dt_bias and the conv biases would otherwise be zeros
and ones a port could drop unseen); the models, the reference's jitted
prefill and its gradients are built once per module. Tolerances: the f32
forward, logits and every cache / state leaf within 2e-5 of the leaf's
largest element; gradients within 1e-4; after a train step the
parameters within 1e-3 of the learning rate and the moments within 1e-4
of their largest element of the reference's AdamW applied to the port's
own gradients (``torch_cross.hold_step``); bf16 logits, and bf16
gradients over four draws of the weights, no further from JAX's f32 than
JAX's own bf16 are, x1.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import tokens as JDATA
from repro.launch.serve import build_cache as jax_build_cache
from repro.models import hybrid as JHY
from repro.models.param import count_params as jax_count_params
from repro.models.registry import get_model as jax_model
from repro.optim import adamw as JADAMW
from repro.optim.schedule import lr_at as jax_lr_at
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import hybrid as HY
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from torch_cross import (configs, jax_params, leaves, numpy_params,
                         perturbed, reference_inits, to_np,
                         spy_on_apply, hold_step, assert_tree_close)

ARCH = "zamba2-2.7b"
TOL, GRAD_TOL = 2e-5, 1e-4
B, P, CACHE = 2, 40, 48          # a 40-token prompt: the chunk shrinks to 20
HASH_SEEDS = (0, 1, 13)          # the reference's init under these salts


@pytest.fixture(scope="module")
def models(mesh):
    """dtype -> (JAX model, its params, the port's Model, the same params,
    the jitted JAX prefill), built once; the bf16 pair holds the f32
    weights rounded."""
    tree = numpy_params(JHY.hybrid_descs(jax_config(ARCH, reduced=True)))
    out = {}
    with mesh:
        for dtype in ("float32", "bfloat16"):
            jcfg, cfg = configs(ARCH, dtype)
            jm = jax_model(jcfg, mesh)
            out[dtype] = (jm, jax_params(jm, tree), Model(cfg, device="cpu"),
                          lm_params_from_numpy(tree, cfg, device="cpu"),
                          jax.jit(jm.prefill))
    return out


@pytest.fixture(scope="module")
def prefilled(models, mesh):
    """The f32 prefill of one 40-token prompt in both packages: (tokens,
    JAX logits, JAX cache, port logits, port cache)."""
    jm, jp, tm, tp, jprefill = models["float32"]
    toks = _tokens(P + 3, seed=2)
    with mesh:
        jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :P],
                                                      jnp.int32)})
    FK.KERNEL.reset_counts()
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P])})
    assert FK.KERNEL.launches == 0
    return toks, jl, jc, tl, tc


@pytest.fixture(scope="module")
def jax_grads(models, mesh):
    """``jax.value_and_grad`` of the reference's f32 ``hybrid_loss`` on
    (params, batch), jitted once."""
    cfg = models["float32"][0].cfg
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JHY.hybrid_loss(p, b, cfg, mesh, ())))

    def call(params, batch):
        with mesh:
            return vg(params, batch)
    return call


def _close(got, want, tol=TOL, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _tokens(S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def _cache_leaves(cache):
    """{(segment, name[, state]): leaf} of a hybrid cache."""
    out = {}
    for i, seg in enumerate(cache):
        for n, t in seg.items():
            if isinstance(t, dict):
                out.update({(i, n, m): s for m, s in t.items()})
            else:
                out[i, n] = t
    return out


def _batch(cfg, step=0, S=P):
    """The reference's batch, as JAX arrays and as torch tensors (40
    tokens: two chunks of 20)."""
    jb = JDATA.batch_at(step, cfg, B, S, seed=0)
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k != "mask" else np.float32)) for k, v in jb.items()}
    return jb, tb


def test_params_cross_and_the_layout(models, mesh):
    """Every leaf of the reference's tree crosses bit for bit, in the
    reference's layout (the trunk stacked (nseg, per, ...), the shared
    blocks (2, ...)) and in its dtypes, and the reference's own init makes
    the same tree of shapes and dtypes."""
    for dtype in ("float32", "bfloat16"):
        jm, jp, tm, tp, _ = models[dtype]
        lj, lt = leaves(jax.tree.map(np.asarray, jp)), leaves(tp)
        assert set(lj) == set(lt)
        for path, a in lj.items():
            assert str(lt[path].dtype) == f"torch.{a.dtype}"
            np.testing.assert_array_equal(to_np(lt[path]),
                                          np.asarray(a, np.float32))
    shapes = lambda t: {k: (tuple(v.shape), str(v.dtype))
                        for k, v in leaves(t).items()}
    assert shapes(jax.eval_shape(jm.init, jax.random.key(0))) == shapes(jp)
    assert tuple(tp["trunk"]["mamba"]["in_x"]["w"].shape) == (2, 2, 64, 128)
    assert tuple(tp["shared"]["attn"]["q"]["w"].shape) == (2, 64, 64)
    assert count_params(tm.param_descs()) == sum(a.size for a in lj.values())


def test_prefill_logits_and_cache_match_jax(prefilled):
    """Prefill over 40 tokens (the chunk shrinks to 20): the logits and
    every cache leaf (each segment's Mamba2 states, stacked per layer, and
    its shared block's K/V) within 2e-5; no kernel launches on the
    CPU."""
    _, jl, jc, tl, tc = prefilled
    assert tl.shape == (B, 256) and len(tc) == len(jc) == 2
    _close(tl, jl, what="logits")
    lt, lj = _cache_leaves(tc), _cache_leaves(jc)
    assert set(lt) == set(lj)
    for key, t in lt.items():
        assert t.dtype == torch.float32, key
        _close(t, lj[key], what=key)


def test_decode_three_steps_match_jax(models, prefilled, mesh):
    """The 40-token prefill spliced into a 48-row cache (the Mamba2 states
    cross whole, K/V along the sequence), then three decode steps fed the
    same tokens: logits and every cache leaf agree each step; and the
    last step's logits equal a prefill over all 43 tokens (the Mamba and
    conv states carry)."""
    jm, jp, tm, tp, _ = models["float32"]
    toks, _, jpc, _, tpc = prefilled
    tc = TS.build_cache(tm, tpc, B, CACHE)
    with mesh:
        jc = jax_build_cache(jm, jpc, B, CACHE)
        step = jax.jit(lambda p, t, po, c: jm.decode(p, t, po, c, CACHE))
        for i in range(3):
            tok = toks[:, P + i:P + i + 1]
            pos = np.full(B, P + i)
            jl, jc = step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc)
            tl, tc = tm.decode(tp, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc)
            _close(tl, jl, what=f"step {i}")
            lt, lj = _cache_leaves(tc), _cache_leaves(jc)
            for key, t in lt.items():
                _close(t, lj[key], what=(i,) + key)
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, full, 1e-4, what="decode vs prefill")


def test_loss_and_grads_match_jax(models, jax_grads):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``hybrid_loss`` (40 tokens: two chunks of 20, so the
    chunk states and the inter-chunk term carry gradient)."""
    jm, jp, tm, tp, _ = models["float32"]
    jb, tb = _batch(jm.cfg)
    jl, jg = jax_grads(jp, jb)
    tl, tg = ST.loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_tree_close(tg, jg, GRAD_TOL, what="grad")


def test_bf16_holds_the_rule_against_jax(models, mesh):
    """bf16 prefill logits on the f32 weights rounded: the port's no
    further from JAX's f32 run than JAX's bf16 run is, x1.5."""
    toks = _tokens(P, seed=5)
    with mesh:
        want, j16 = (np.asarray(models[d][4](models[d][1], {
            "tokens": jnp.asarray(toks, jnp.int32)})[0], np.float32)
            for d in ("float32", "bfloat16"))
    _, _, tm, tp, _ = models["bfloat16"]
    t16 = to_np(tm.prefill(tp, {"tokens": torch.from_numpy(toks)})[0])
    err = lambda a: float(np.abs(a - want).max()) / float(np.abs(want).max())
    assert err(t16) <= 1.5 * err(j16)


def _grad_errs(grads, ref):
    """{leaf: max |g - g_ref| / max |g_ref|}."""
    g, r = leaves(grads), leaves(ref)
    return {"/".join(p): float(np.abs(to_np(g[p]) - to_np(r[p])).max())
            / max(float(np.abs(to_np(r[p])).max()), 1e-30) for p in r}


def _bf16_draw(tree, jm, jm16, tm16, grads32, grads16, jb, tb, mesh):
    """({leaf: the port's bf16 gradient error}, {leaf: JAX's}) on the
    weights ``tree`` (the bf16 runs get them rounded), each error
    :func:`_grad_errs` against JAX's f32 gradient; ``grads32`` /
    ``grads16`` are JAX's jitted ``value_and_grad`` of ``hybrid_loss``."""
    with mesh:
        _, g32 = grads32(jax_params(jm, tree), jb)
        _, g16 = grads16(jax_params(jm16, tree), jb)
    _, t16 = ST.loss_and_grads(
        tm16, lm_params_from_numpy(tree, tm16.cfg, device="cpu"), tb)
    return _grad_errs(t16, g32), _grad_errs(g16, g32)


def _draw_line(name, port, ref):
    """One draw's worst-leaf ratio and each package's worst leaf."""
    wt, wj = max(port, key=port.get), max(ref, key=ref.get)
    return (f"{name}: ratio {port[wt] / ref[wj]:.3f}; port {wt} "
            f"{port[wt]:.4f}, JAX {wj} {ref[wj]:.4f}")


def test_bf16_grads_hold_the_rule_against_jax(models, jax_grads, mesh,
                                              tmp_path):
    """bf16 loss gradients (40 tokens, two chunks) on the f32 weights
    rounded, against JAX's f32 gradients, over four draws of the weights:
    the reference's own init under PYTHONHASHSEED 0, 1 and 13, perturbed,
    and the numpy draw of the other tests. Over the draws and leaves, the
    port's worst max |g - g_f32| / max |g_f32| is no more than 1.5 x
    JAX's bf16 worst; and for every leaf the geometric mean over the draws
    of the port's error over JAX's is at most 1.5, so a rounding point
    where the port differs from the reference, which would raise one leaf
    in every draw, shows. One draw's own worst-leaf ratio is noisy (a
    max over as few as 32 elements): salt 13 gives 1.67 with A_log worst,
    the one of 29 draws over 1.5 (PERF.md; ``tests/torch_bf16_draws.py``
    takes more draws). Each draw's ratio and worst leaves are printed
    (``-s``)."""
    inits = reference_inits(ARCH, "repro.models.hybrid:hybrid_descs",
                            tmp_path, HASH_SEEDS)
    jm, _, _, _, _ = models["float32"]
    jm16, _, tm16, _, _ = models["bfloat16"]
    jb, tb = _batch(jm.cfg)
    with mesh:        # compiled while the inits run
        vg16 = jax.jit(jax.value_and_grad(
            lambda p, b: JHY.hybrid_loss(p, b, jm16.cfg, mesh, ()))).lower(
                models["bfloat16"][1], jb).compile()
    draws = {f"init, PYTHONHASHSEED {s}": perturbed(t)
             for s, t in inits().items()}
    draws["numpy draw 0"] = numpy_params(
        JHY.hybrid_descs(jax_config(ARCH, reduced=True)))
    port, ref = [], []
    for name, tree in draws.items():
        errs = _bf16_draw(tree, jm, jm16, tm16, jax_grads, vg16, jb, tb,
                          mesh)
        port.append(errs[0])
        ref.append(errs[1])
        print(_draw_line(name, *errs))
    worst = lambda errs: max(max(e.values()) for e in errs)
    assert worst(port) <= 1.5 * worst(ref), (worst(port), worst(ref))
    for leaf in ref[0]:
        geo = float(np.exp(np.mean([np.log(p[leaf] / r[leaf])
                                    for p, r in zip(port, ref)])))
        assert geo <= 1.5, (leaf, geo)


def test_remat_equals_no_remat(models):
    """Under ``remat="full"`` each Mamba2 layer and each shared block is
    recomputed in the backward: the loss and every gradient equal the
    stored-activation run's bit for bit."""
    _, _, tm, tp, _ = models["float32"]
    _, tb = _batch(tm.cfg, step=3)
    runs = [ST.loss_and_grads(Model(tm.cfg.replace(remat=r), device="cpu"),
                              tp, tb) for r in ("none", "full")]
    assert float(runs[0][0]) == float(runs[1][0])
    for path, g in leaves(runs[0][1]).items():
        assert torch.equal(g, leaves(runs[1][1])[path]), path


def test_train_step_matches_jax(models, jax_grads, mesh, monkeypatch):
    """Two train steps (warmup 1, so the first step's lr is 0 and the
    second's the peak) from the same weights and batches: loss, gnorm,
    lr, mu and nu against the reference's step, composed as its
    ``make_train_step`` composes it; the gradients the port's step used
    against the reference's at the same parameters, and every parameter,
    mu and nu against the reference's AdamW on those gradients
    (``hold_step``: held against the reference's own parameters, an
    element whose gradient sits next to eps turns a gradient difference
    of 4e-8 of its leaf's largest into 3e-3 of the learning rate)."""
    jm, jp, tm, tp, _ = models["float32"]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    japply = jax.jit(lambda p, g, o: JADAMW.apply(p, g, o,
                                                   jcfg, jax_lr_at(o.step,
                                                                   jcfg)))
    seen = spy_on_apply(monkeypatch)
    tstep = ST.make_train_step(tm, tcfg)
    jparams, jopt = jp, JADAMW.init(jp, jcfg)
    tstate = {"params": adamw.tree_map(torch.clone, tp),
              "opt": adamw.init(tp, tcfg)}
    for step in range(2):
        jb, tb = _batch(jm.cfg, step=step)
        jl, jg = jax_grads(jparams, jb)
        jlr = float(jax_lr_at(jopt.step, jcfg))
        jparams, jopt, jgnorm = japply(jparams, jg, jopt)
        tstate, tmet = tstep(tstate, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jl),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jgnorm),
                                   rtol=1e-4)
        assert float(tmet["lr"]) == pytest.approx(jlr, rel=1e-6)
        hold_step(tstate, seen[-1], japply,
                  lambda p: jax_grads(p, jb)[1], GRAD_TOL,
                  kw["learning_rate"], what=f"step {step}")
        assert_tree_close(tstate["opt"].mu, jopt.mu, 1e-4, what="mu")
        assert_tree_close(tstate["opt"].nu, jopt.nu, 1e-4, what="nu")


def test_serve_and_train_clis_on_the_cpu(tmp_path, capsys):
    toks = TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt", "8", "--gen", "3",
                    "--cache", "16"])
    assert tuple(toks.shape) == (2, 3)
    assert f"[serve] {ARCH}: generated (2, 3)" in capsys.readouterr().out
    losses = TR.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] done on cpu" in capsys.readouterr().out


def test_full_config_is_the_references():
    """Every field of the full config (the SSM and hybrid sub-configs too)
    equals the reference's, and so does the parameter count from the
    descriptors alone, part by part, with nothing allocated."""
    ref, port = jax_config(ARCH), get_config(ARCH)
    for f in port.__dataclass_fields__:
        want, got = getattr(ref, f), getattr(port, f)
        if f in ("ssm", "hybrid"):
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    descs = Model(port, device="cpu").param_descs()
    assert count_params(descs) == jax_count_params(JHY.hybrid_descs(ref)) \
        == 2_527_532_960
    assert [count_params(descs[k]) for k in ("trunk", "shared", "embed")] \
        == [2_153_964_960, 209_725_440, 163_840_000]
    assert HY._plan(port) == (9, 6)
    assert port.resolved_head_dim == 80 and port.remat == "full"
