"""The port's ssm family (rwkv6-3b: attention-free time mix with
data-dependent decay) against the JAX package on the CPU, at REDUCED
width (2 layers, d 64, head 16, chunk 32), on the (1, 1) mesh.

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.numpy_params``: the unit leaves and ``decay_base``'s
constant -4 perturbed per channel, so a port that drops a leaf or swaps
the state's key and value axes shows); the models and the reference's
jitted functions are built once per module. Tolerances: the f32 forward,
logits and every state leaf within 2e-5 of the leaf's largest element;
gradients within 1e-4; after a train step the parameters within 1e-3 of
the learning rate and the moments within 1e-4 of their largest element
of the reference's AdamW applied to the port's own gradients
(``torch_cross.hold_step``); bf16 logits, and bf16 gradients over four
draws of the weights, no further from JAX's f32 than JAX's own bf16 are,
x1.5.
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
from repro.models import rwkv as JR
from repro.models import rwkv_lm as JRL
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
from repro_torch.models import rwkv as R
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from torch_cross import (configs, jax_params, leaves, numpy_params,
                         perturbed, reference_inits, to_np,
                         spy_on_apply, hold_step, assert_tree_close)

ARCH = "rwkv6-3b"
TOL, GRAD_TOL = 2e-5, 1e-4
B, P, CACHE = 2, 40, 48          # a 40-token prompt: the chunk shrinks to 20
HASH_SEEDS = (0, 1, 13)          # the reference's init under these salts


@pytest.fixture(scope="module")
def models(mesh):
    """dtype -> (JAX model, its params, the port's Model, the same params,
    the jitted JAX prefill), built once; the bf16 pair holds the f32
    weights rounded (``decay_base`` and ``bonus`` stay f32)."""
    tree = numpy_params(JRL.rwkv_lm_descs(jax_config(ARCH, reduced=True)))
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
    """``jax.value_and_grad`` of the reference's f32 ``rwkv_loss`` on
    (params, batch), jitted once."""
    cfg = models["float32"][0].cfg
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JRL.rwkv_loss(p, b, cfg, mesh, ())))

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


def _batch(cfg, step=0, S=P):
    """The reference's batch, as JAX arrays and as torch tensors (40
    tokens: two chunks of 20)."""
    jb = JDATA.batch_at(step, cfg, B, S, seed=0)
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k != "mask" else np.float32)) for k, v in jb.items()}
    return jb, tb


def _layer(tree, i=0):
    """Layer i of the stacked blocks of a nested numpy / JAX tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _both(x):
    """A numpy array as (a JAX array, a torch tensor), f32."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def test_params_cross_and_the_layout(models):
    """Every leaf of the reference's tree crosses bit for bit, in the
    reference's layout (the blocks stacked (L, ...)) and dtypes: in the
    bf16 model ``decay_base`` and ``bonus`` stay f32; and the reference's
    own init makes the same tree of shapes and dtypes."""
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
    for name in ("decay_base", "bonus"):
        assert tp["blocks"]["tm"][name].dtype == torch.float32
        assert tuple(tp["blocks"]["tm"][name].shape) == (2, 4, 16)
    assert tp["blocks"]["tm"]["r"]["w"].dtype == torch.bfloat16
    assert tuple(tp["blocks"]["tm"]["maa_w2"].shape) == (2, 5, 32, 64)
    assert count_params(tm.param_descs()) == sum(a.size for a in lj.values())


def test_mixing_and_norm_pieces_match_jax(models):
    """``_token_shift``, ``_ddlerp`` and ``_group_norm`` of the first
    block's time mix on the same f32 inputs."""
    jm, jp, tm, tp, _ = models["float32"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 12, 64)).astype(np.float32)
    prev = rng.standard_normal((B, 64)).astype(np.float32)
    (jx, tx), (jprev, tprev) = _both(x), _both(prev)
    _close(R._token_shift(tx, tprev), JR._token_shift(jx, jprev), 0,
           what="token shift")
    jtm, ttm = _layer(jp["blocks"]["tm"]), _layer(tp["blocks"]["tm"])
    xs = np.roll(x, 1, axis=1)
    jxs, txs = _both(xs)
    _close(R._ddlerp(ttm, tx, txs), jax.jit(JR._ddlerp)(jtm, jx, jxs),
           what="ddlerp")
    gn = jax.jit(JR._group_norm, static_argnums=3)
    _close(R._group_norm(tx, ttm["gn_scale"], ttm["gn_bias"], 4),
           gn(jx, jtm["gn_scale"], jtm["gn_bias"], 4), what="group norm")


@pytest.mark.parametrize("S,case", [(64, "two chunks"), (40, "chunk of 20"),
                                    (64, "state0"), (64, "clipped")])
def test_wkv6_chunked_matches_jax(S, case):
    """The chunked scan's output and final state, from per-channel decays
    (the reference's ``decay_base`` -4 moved per channel and step, so a
    decay applied to the state's value axis instead of its key axis
    would show): over two chunks of 32, over a 40-token sequence whose
    chunk shrinks to 20, from a nonzero entering state, and with decays
    so strong that the exponents hit the +-60 clips (b up to e^60)."""
    rng = np.random.default_rng(S + len(case))
    H, D = 4, 16
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    spread = 4.0 if case == "clipped" else 0.5
    dec = (-4.0 + (3.0 if case == "clipped" else 0.0)
           + spread * rng.standard_normal((H, D))
           + 0.3 * rng.standard_normal((B, S, H, D)))
    lw = (-np.exp(np.clip(dec, -8.0, 8.0))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)).astype(np.float32)
          if case == "state0" else None)
    fn = jax.jit(JR.wkv6_chunked, static_argnums=5)
    jy, js = fn(*(jnp.asarray(a) for a in (r, k, v, lw, u)), 32,
                None if s0 is None else jnp.asarray(s0))
    ty, ts = R.wkv6_chunked(*(torch.from_numpy(a) for a in (r, k, v, lw, u)),
                            32, None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy, what=f"{case} y")
    _close(ts, js, what=f"{case} state")
    if case == "clipped":
        cs = np.cumsum(lw.reshape(B, S // 32, 32, H, D), axis=2)
        assert cs.min() < -60, "the clipped case should reach the clips"


def test_block_train_and_decode_match_jax(models):
    """``rwkv6_block_train`` over 40 tokens, and three
    ``rwkv6_block_decode`` steps from the state the train form ends in:
    outputs and every state leaf."""
    jm, jp, tm, tp, _ = models["float32"]
    jcfg, cfg = jm.cfg, tm.cfg
    jl, tl = _layer(jp["blocks"]), _layer(tp["blocks"])
    x = np.random.default_rng(4).standard_normal((B, P + 3, 64)).astype(
        np.float32)
    jx, tx = _both(x)
    want = jax.jit(lambda p, h: JR.rwkv6_block_train(p, h, jcfg))(jl, jx[:, :P])
    got, state = R.rwkv6_block_train(tl, tx[:, :P], cfg, return_state=True)
    _close(got, want, what="block train")
    step = jax.jit(lambda p, h, s: JR.rwkv6_block_decode(p, h, jcfg, s))
    jstate = {n: jnp.asarray(to_np(t)) for n, t in state.items()}
    for i in range(3):
        jy, jstate = step(jl, jx[:, P + i:P + i + 1], jstate)
        ty, state = R.rwkv6_block_decode(tl, tx[:, P + i:P + i + 1], cfg,
                                         state)
        _close(ty, jy, what=f"decode step {i}")
        for n, t in state.items():
            assert t.dtype == torch.float32, n
            _close(t, jstate[n], what=(i, n))


def test_prefill_logits_and_state_match_jax(prefilled):
    """Prefill over 40 tokens (the chunk shrinks to 20): the logits and
    every leaf of the stacked state (tm_x, cm_x, wkv; (L, B, ...) f32)
    within 2e-5; no kernel launches."""
    _, jl, jc, tl, tc = prefilled
    assert tl.shape == (B, 256)
    _close(tl, jl, what="logits")
    assert set(tc) == set(jc) == {"tm_x", "cm_x", "wkv"}
    assert tuple(tc["wkv"].shape) == (2, B, 4, 16, 16)
    for n, t in tc.items():
        assert t.dtype == torch.float32, n
        _close(t, jc[n], what=n)


def test_decode_three_steps_match_jax(models, prefilled, mesh):
    """The prefill's state as the decode cache (it crosses whole), then
    three decode steps fed the same tokens: logits and every state leaf
    agree each step, the state is updated in place, and the last step's
    logits equal a prefill over all 43 tokens."""
    jm, jp, tm, tp, _ = models["float32"]
    toks, _, jpc, _, tpc = prefilled
    tc = TS.build_cache(tm, {n: t.clone() for n, t in tpc.items()}, B, CACHE)
    ptrs = {n: t.data_ptr() for n, t in tc.items()}
    FK.KERNEL.reset_counts()
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
            for n, t in tc.items():
                assert t.data_ptr() == ptrs[n], n
                _close(t, jc[n], what=(i, n))
    assert FK.KERNEL.launches == 0
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, full, 1e-4, what="decode vs prefill")


def test_loss_and_grads_match_jax(models, jax_grads):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``rwkv_loss`` (40 tokens: two chunks of 20, so the
    chunk states and the inter-chunk term carry gradient)."""
    jm, jp, tm, tp, _ = models["float32"]
    jb, tb = _batch(jm.cfg)
    jl, jg = jax_grads(jp, jb)
    tl, tg = ST.loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_tree_close(tg, jg, GRAD_TOL, what="grad")
    assert tg["blocks"]["tm"]["decay_base"].dtype == torch.float32


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
    assert err(t16) <= 1.5 * err(j16), (err(t16), err(j16))


def _grad_errs(grads, ref):
    """{leaf: max |g - g_ref| / max |g_ref|}."""
    g, r = leaves(grads), leaves(ref)
    return {"/".join(p): float(np.abs(to_np(g[p]) - to_np(r[p])).max())
            / max(float(np.abs(to_np(r[p])).max()), 1e-30) for p in r}


def test_bf16_grads_hold_the_rule_against_jax(models, jax_grads, mesh,
                                              tmp_path):
    """bf16 loss gradients (40 tokens, two chunks) on the f32 weights
    rounded, against JAX's f32 gradients, over four draws of the weights:
    the reference's own init under PYTHONHASHSEED 0, 1 and 13, perturbed,
    and the numpy draw of the other tests. Over the draws and leaves, the
    port's worst max |g - g_f32| / max |g_f32| is no more than 1.5 x
    JAX's bf16 worst; and for every leaf the geometric mean over the
    draws of the port's error over JAX's is at most 1.5. Each draw's
    worst leaves are printed (``-s``)."""
    inits = reference_inits(ARCH, "repro.models.rwkv_lm:rwkv_lm_descs",
                            tmp_path, HASH_SEEDS)
    jm, _, _, _, _ = models["float32"]
    jm16, jp16, tm16, _, _ = models["bfloat16"]
    jb, tb = _batch(jm.cfg)
    with mesh:        # compiled while the inits run
        vg16 = jax.jit(jax.value_and_grad(
            lambda p, b: JRL.rwkv_loss(p, b, jm16.cfg, mesh, ()))).lower(
                jp16, jb).compile()
    draws = {f"init, PYTHONHASHSEED {s}": perturbed(t)
             for s, t in inits().items()}
    draws["numpy draw 0"] = numpy_params(
        JRL.rwkv_lm_descs(jax_config(ARCH, reduced=True)))
    port, ref = [], []
    for name, tree in draws.items():
        _, g32 = jax_grads(jax_params(jm, tree), jb)
        with mesh:
            _, g16 = vg16(jax_params(jm16, tree), jb)
        _, t16 = ST.loss_and_grads(
            tm16, lm_params_from_numpy(tree, tm16.cfg, device="cpu"), tb)
        port.append(_grad_errs(t16, g32))
        ref.append(_grad_errs(g16, g32))
        wt = max(port[-1], key=port[-1].get)
        wj = max(ref[-1], key=ref[-1].get)
        print(f"{name}: port {wt} {port[-1][wt]:.4f}, JAX {wj} "
              f"{ref[-1][wj]:.4f}")
    worst = lambda errs: max(max(e.values()) for e in errs)
    assert worst(port) <= 1.5 * worst(ref), (worst(port), worst(ref))
    for leaf in ref[0]:
        geo = float(np.exp(np.mean([np.log(p[leaf] / r[leaf])
                                    for p, r in zip(port, ref)])))
        assert geo <= 1.5, (leaf, geo)


def test_remat_equals_no_remat(models):
    """Under ``remat="full"`` each block is recomputed in the backward:
    the loss and every gradient equal the stored-activation run's bit for
    bit."""
    _, _, tm, tp, _ = models["float32"]
    _, tb = _batch(tm.cfg, step=3)
    runs = [ST.loss_and_grads(Model(tm.cfg.replace(remat=r), device="cpu"),
                              tp, tb) for r in ("none", "full")]
    assert float(runs[0][0]) == float(runs[1][0])
    for path, g in leaves(runs[0][1]).items():
        assert torch.equal(g, leaves(runs[1][1])[path]), path


def test_train_step_matches_jax(models, jax_grads, mesh, monkeypatch):
    """Two train steps (warmup 1, so the first step's lr is 0 and the
    second's the peak) from the same weights and 40-token batches: loss,
    gnorm, lr, mu and nu against the reference's step, composed as its
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
    """Every field of the full config (the SSM sub-config too) equals the
    reference's, and so does the parameter count from the descriptors
    alone, part by part, with nothing allocated."""
    ref, port = jax_config(ARCH), get_config(ARCH)
    for f in port.__dataclass_fields__:
        want, got = getattr(ref, f), getattr(port, f)
        if f == "ssm":
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    descs = Model(port, device="cpu").param_descs()
    assert count_params(descs) == jax_count_params(JRL.rwkv_lm_descs(ref)) \
        == 3_094_620_160
    assert [count_params(descs[k]) for k in ("blocks", "embed")] \
        == [2_759_065_600, 335_544_320]
    assert port.resolved_head_dim == 64 and port.remat == "full"
