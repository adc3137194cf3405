"""The port's vlm family (llava-next-mistral-7b: the dense decoder after a
prefix of stub patch embeddings) against the JAX package on the CPU, at
REDUCED width (2 layers, d 64, 4/2 heads of 16, vocabulary 256, 16
patches), on the (1, 1) mesh.

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.numpy_params``, the rms-norm scales moved off 1) and the
same numpy patches and tokens; the models and the reference's jitted
functions are built once per module. Tolerances: the f32 logits and
every cache leaf within 1e-5 of the leaf's largest element; the loss
1e-5 relative and every gradient leaf within 1e-4 of its largest
element; bf16 logits and bf16 gradients, over four numpy draws of the
weights, no further from JAX's f32 than JAX's own bf16 are, x1.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import tokens as JDATA
from repro.launch.serve import build_cache as jax_build_cache
from repro.launch.serve import serve as jax_serve
from repro.models import lm as JLM
from repro.models.param import count_params as jax_count_params
from repro.models.registry import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import tokens as DATA
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import layers as TL
from repro_torch.models import lm as LM
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from torch_cross import configs, jax_params, leaves, numpy_params, to_np

ARCH = "llava-next-mistral-7b"
TOL, GRAD_TOL = 1e-5, 1e-4
B, N_PATCH, D_MODEL = 2, 16, 64
# a 12-token prompt after the 16 patches, three decode steps at positions
# 28, 29 and 30
P, CACHE = 12, 32
NUMPY_DRAWS = (0, 1, 2, 3)       # the bf16 gradient rule's weight draws


def _patches(seed=7, n=B):
    """Stub patch embeddings (n, 16, d) at the stub's scale, f32 numpy."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (n, N_PATCH, D_MODEL))).astype(np.float32)


def _tokens(S, seed=1, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, S))


def _inputs(patches, tokens, dtype):
    """The same patches and tokens for both packages: ({"patches",
    "tokens"} as JAX arrays, as torch tensors), patches in ``dtype``."""
    jb = {"patches": jnp.asarray(patches, jnp.dtype(dtype)),
          "tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"patches": torch.from_numpy(patches.copy()).to(getattr(torch,
                                                                  dtype)),
          "tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
    return jb, tb


def _descs():
    return JLM.lm_descs(jax_config(ARCH, reduced=True).replace(
        dtype="float32", param_dtype="float32"))


@pytest.fixture(scope="module")
def models(mesh):
    """dtype -> (JAX model, its params, the port's Model, the same params,
    the jitted JAX prefill), built once; the bf16 pair holds the f32
    weights rounded."""
    tree = numpy_params(_descs())
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
    """The f32 prefill of 16 patches + a 12-token prompt in both packages:
    (patches, tokens, JAX logits, JAX cache, port logits, port cache)."""
    jm, jp, tm, tp, jprefill = models["float32"]
    patches, toks = _patches(), _tokens(P + 3, seed=2)
    jb, tb = _inputs(patches, toks[:, :P], "float32")
    with mesh:
        jl, jc = jprefill(jp, jb)
    FK.KERNEL.reset_counts()
    tl, tc = tm.prefill(tp, tb)
    assert FK.KERNEL.launches == 0
    return patches, toks, jl, jc, tl, tc


@pytest.fixture(scope="module")
def jax_grads(models, mesh):
    """dtype -> ``jax.value_and_grad`` of the reference's ``lm_loss`` on
    (params, batch), jitted once."""
    fns = {d: jax.jit(jax.value_and_grad(
        lambda p, b, c=models[d][0].cfg: JLM.lm_loss(p, b, c, mesh, ())))
        for d in ("float32", "bfloat16")}

    def call(dtype, params, batch):
        with mesh:
            return fns[dtype](params, batch)
    return call


def _close(got, want, tol=TOL, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _batch(cfg, step=0, S=20, dtype="float32"):
    """The reference's token batch with stub patches, as JAX arrays and as
    torch tensors."""
    jb = dict(JDATA.batch_at(step, cfg, B, S, seed=0))
    jb["patches"] = jnp.asarray(_patches(seed=11 + step), jnp.dtype(dtype))
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k in ("tokens", "targets") else np.float32))
        for k, v in jb.items()}
    tb["patches"] = tb["patches"].to(getattr(torch, dtype))
    return jb, tb


def _grad_errs(grads, ref):
    """{leaf: max |g - g_ref| / max |g_ref|}."""
    g, r = leaves(grads), leaves(ref)
    return {"/".join(p): float(np.abs(to_np(g[p]) - to_np(r[p])).max())
            / max(float(np.abs(to_np(r[p])).max()), 1e-30) for p in r}


def test_params_cross_and_the_layout(models):
    """Every leaf of the reference's tree crosses bit for bit in the
    port's dtype; the tree is the dense family's (the stub has no
    parameters while ``patch_embed_dim`` is 0), and the reference's own
    init makes the same tree of shapes and dtypes."""
    for dtype in ("float32", "bfloat16"):
        jm, jp, tm, tp, _ = models[dtype]
        lj, lt = leaves(jax.tree.map(np.asarray, jp)), leaves(tp)
        assert set(lj) == set(lt)
        for path, a in lj.items():
            assert str(lt[path].dtype) == f"torch.{a.dtype}"
            np.testing.assert_array_equal(to_np(lt[path]),
                                          np.asarray(a, np.float32))
    assert tm.cfg.vision.patch_embed_dim == 0
    dense = Model(tm.cfg.replace(family="dense", vision=None), device="cpu")
    shapes = lambda t: {k: (tuple(v.shape), str(v.dtype))
                        for k, v in leaves(t).items()}
    assert shapes(dense.param_descs()) == shapes(tm.param_descs())
    assert shapes(jax.eval_shape(jm.init, jax.random.key(0))) == shapes(jp)
    assert set(tp) == {"embed", "final_norm", "stack_0_dense"}
    assert count_params(tm.param_descs()) == sum(a.size for a in lj.values())


def test_prefill_logits_and_cache_match_jax(prefilled):
    """Prefill over the 16 patches and 12 tokens: the logits and every
    cache leaf (k, v over all 28 positions, RoPE numbering the patches
    0..15) within 1e-5; no kernel launches on the CPU."""
    _, _, jl, jc, tl, tc = prefilled
    assert tl.shape == (B, 256) and len(tc) == len(jc) == 2
    _close(tl, jl, what="logits")
    for i, (t, j) in enumerate(zip(tc, jc)):
        assert set(t) == set(j) == {"k", "v"}
        assert tuple(t["k"].shape) == (B, N_PATCH + P, 2, 16)
        for n in t:
            _close(t[n], j[n], what=(i, n))


def test_decode_three_steps_match_jax(models, prefilled, mesh):
    """The 28-position prefill spliced into a 32-row cache, then three
    decode steps at positions 16 + 12, 16 + 13 and 16 + 14 fed the same
    tokens: logits and every cache leaf agree each step; and the last
    step's logits equal a prefill of the patches and all 15 tokens."""
    jm, jp, tm, tp, _ = models["float32"]
    patches, toks, _, jpc, _, tpc = prefilled
    tc = TS.build_cache(tm, tpc, B, CACHE)
    assert tuple(tc[0]["k"].shape) == (B, CACHE, 2, 16)
    with mesh:
        jc = jax_build_cache(jm, jpc, B, CACHE)
        step = jax.jit(lambda p, t, po, c: jm.decode(p, t, po, c, CACHE))
        for i in range(3):
            tok = toks[:, P + i:P + i + 1]
            pos = np.full(B, N_PATCH + P + i)
            jl, jc = step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc)
            tl, tc = tm.decode(tp, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc)
            _close(tl, jl, what=f"step {i}")
            for layer, (t, j) in enumerate(zip(tc, jc)):
                for n in t:
                    _close(t[n], j[n], what=(i, layer, n))
    _, tb = _inputs(patches, toks[:, :P + 3], "float32")
    h = LM.lm_hidden(tp, tb, tm.cfg)
    assert h.shape == (B, N_PATCH + P + 3, D_MODEL)
    last = TL.logits_fn(tp["embed"], h[:, -1:], False)[:, 0]
    _close(tl, last, 1e-4, what="decode vs forward")


def test_loss_and_grads_match_jax(models, jax_grads):
    """The loss over the text positions and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` with patches;
    the patches change the loss (they are attended to) but not its
    positions."""
    jm, jp, tm, tp, _ = models["float32"]
    jb, tb = _batch(jm.cfg)
    jl, jg = jax_grads("float32", jp, jb)
    tl, tg = ST.loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for path, err in _grad_errs(tg, jg).items():
        assert err <= GRAD_TOL, (path, err)
    bare = {k: v for k, v in tb.items() if k != "patches"}
    assert abs(float(LM.lm_loss(tp, bare, tm.cfg)) - float(tl)) > 1e-4


def test_bf16_holds_the_rule_against_jax(models, jax_grads, mesh):
    """bf16 on the f32 weights rounded, against JAX's f32 run on the same
    inputs, x1.5 of JAX's bf16 distance: the prefill logits of one draw;
    the loss gradients over four numpy draws of the weights, the port's
    worst leaf over the draws against JAX's worst, and per leaf the
    geometric mean over the draws of the port's error over JAX's. Each
    draw's worst leaves are printed (``-s``)."""
    jm, _, _, _, _ = models["float32"]
    jm16, jp16, tm16, tp16, jprefill16 = models["bfloat16"]
    patches, toks = _patches(seed=13), _tokens(24, seed=5)
    with mesh:
        want = to_np(models["float32"][4](models["float32"][1],
                                          _inputs(patches, toks,
                                                  "float32")[0])[0])
        j16 = to_np(jprefill16(jp16, _inputs(patches, toks, "bfloat16")[0])[0])
    t16 = to_np(tm16.prefill(tp16, _inputs(patches, toks, "bfloat16")[1])[0])
    err = lambda a: float(np.abs(a - want).max()) / float(np.abs(want).max())
    assert err(t16) <= 1.5 * err(j16), (err(t16), err(j16))

    jb, _ = _batch(jm.cfg)
    jb16, tb16 = _batch(jm.cfg, dtype="bfloat16")
    port, ref = [], []
    for seed in NUMPY_DRAWS:
        tree = numpy_params(_descs(), seed)
        _, g32 = jax_grads("float32", jax_params(jm, tree), jb)
        _, g16 = jax_grads("bfloat16", jax_params(jm16, tree), jb16)
        _, t = ST.loss_and_grads(
            tm16, lm_params_from_numpy(tree, tm16.cfg, device="cpu"), tb16)
        port.append(_grad_errs(t, g32))
        ref.append(_grad_errs(g16, g32))
        wt, wj = max(port[-1], key=port[-1].get), max(ref[-1], key=ref[-1].get)
        print(f"numpy draw {seed}: port {wt} {port[-1][wt]:.4f}, JAX {wj} "
              f"{ref[-1][wj]:.4f}")
    worst = lambda errs: max(max(e.values()) for e in errs)
    assert worst(port) <= 1.5 * worst(ref), (worst(port), worst(ref))
    for leaf in ref[0]:
        geo = float(np.exp(np.mean([np.log(p[leaf] / r[leaf])
                                    for p, r in zip(port, ref)])))
        assert geo <= 1.5, (leaf, geo)


def test_serve_tokens_equal_jax_serve(models, mesh):
    """``serve()`` from the patches and a 12-token prompt, the decode
    positions starting at 16 + 12 as the reference's launcher passes
    them: the greedy tokens equal the reference's."""
    jm, jp, tm, tp, _ = models["float32"]
    jb, tb = _inputs(_patches(seed=3), _tokens(P, seed=3), "float32")
    want, _ = jax_serve(jm, jp, jb, N_PATCH + P, 4, CACHE)
    got, _ = TS.serve(tm, tp, tb, N_PATCH + P, 4, CACHE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_modality_stub_patches():
    """``add_modality_stub`` gives the vlm family patches of the
    reference's shape and dtype at the stub's scale, on the tokens'
    device; the same (seed, step) draws the same patches, another step
    other ones."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = configs(ARCH, dtype)
        tokens = torch.zeros(3, 5, dtype=torch.int64)
        got = DATA.add_modality_stub({"tokens": tokens}, cfg, 4, seed=2)
        want = JDATA.add_modality_stub({"tokens": jnp.zeros((3, 5),
                                                            jnp.int32)},
                                       jcfg, 4, seed=2)
        p = got["patches"]
        assert set(got) == set(want) == {"tokens", "patches"}
        assert tuple(p.shape) == tuple(want["patches"].shape) == (3, N_PATCH,
                                                                  D_MODEL)
        assert str(p.dtype) == f"torch.{want['patches'].dtype}"
        assert p.device == tokens.device
        assert 0.015 < float(p.float().std()) < 0.025
        again = DATA.add_modality_stub({"tokens": tokens}, cfg, 4, seed=2)
        assert torch.equal(again["patches"], p)
        other = DATA.add_modality_stub({"tokens": tokens}, cfg, 5, seed=2)
        assert not torch.equal(other["patches"], p)


def test_serve_and_train_clis_on_the_cpu(tmp_path, capsys):
    """The launchers with ``--arch llava-next-mistral-7b --reduced``: serve
    from 16 patches + 8 tokens into a 28-row cache (3 tokens), and two
    train steps."""
    toks = TS.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt", "8", "--gen", "3",
                    "--cache", "28"])
    assert tuple(toks.shape) == (2, 3)
    assert f"[serve] {ARCH}: generated (2, 3)" in capsys.readouterr().out
    losses = TR.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_full_width_config_is_the_references():
    """Every field of the full-width config (the vision stub's too) equals
    the reference's, and so does the parameter count of the whole tree,
    from the descriptors alone; the 12-layer training cut's too."""
    ref, port = jax_config(ARCH), get_config(ARCH)
    for f in port.__dataclass_fields__:
        want, got = getattr(ref, f), getattr(port, f)
        if f == "vision":
            assert vars(got) == vars(want)
        else:
            assert got == want, f
    assert (port.family, port.vision.num_patches) == ("vlm", 2880)
    want = jax_count_params(JLM.lm_descs(ref))
    assert count_params(Model(port, device="cpu").param_descs()) == want
    cut = port.replace(num_layers=12)
    assert count_params(Model(cut, device="cpu").param_descs()) == (
        jax_count_params(JLM.lm_descs(ref.replace(num_layers=12))))
    assert want == 7_241_732_096
