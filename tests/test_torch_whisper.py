"""The port's encdec family (whisper-tiny: an encoder over stub frame
embeddings, a decoder with causal self-attention and cross attention)
against the JAX package on the CPU, at REDUCED width (2 + 2 layers, d 64,
4 heads of 16, 32 frames, a 64-row decoder position table), on the (1, 1)
mesh.

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.numpy_params``, the unit leaves perturbed: the layer-norm
scales and biases and the FFN biases would otherwise be ones and zeros a
port could drop unseen) and the same frames; the models and the
reference's jitted functions are built once per module. Tolerances: the
f32 forward, logits and every cache leaf within 2e-5 of the leaf's
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
from repro.models import attention as JA
from repro.models import whisper as JW
from repro.models.param import count_params as jax_count_params
from repro.models.registry import get_model as jax_model
from repro.optim import adamw as JADAMW
from repro.optim.schedule import lr_at as jax_lr_at
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import tokens as DATA
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import whisper as W
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from torch_cross import (configs, jax_params, leaves, numpy_params,
                         perturbed, reference_inits, to_np,
                         spy_on_apply, hold_step, assert_tree_close)

ARCH = "whisper-tiny"
TOL, GRAD_TOL = 2e-5, 1e-4
B, F, D_MODEL = 2, 32, 64
# a 62-token prompt and three decode steps at positions 62, 63 and 64: the
# last one past the 64-row position table, whose last row it reads
P, CACHE = 62, 72
HASH_SEEDS = (0, 1, 13)          # the reference's init under these salts



def _frames(seed=7):
    """Stub frame embeddings (B, F, d) at the stub's scale, f32 numpy."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, F, D_MODEL))).astype(np.float32)


def _inputs(frames, tokens, dtype):
    """The same frames and tokens for both packages: ({"frames",
    "tokens"} as JAX arrays, as torch tensors), frames in ``dtype``."""
    jb = {"frames": jnp.asarray(frames, jnp.dtype(dtype)),
          "tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"frames": torch.from_numpy(frames.copy()).to(getattr(torch,
                                                                dtype)),
          "tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
    return jb, tb


@pytest.fixture(scope="module")
def models(mesh):
    """dtype -> (JAX model, its params, the port's Model, the same params,
    the jitted JAX prefill), built once; the bf16 pair holds the f32
    weights rounded."""
    tree = numpy_params(JW.whisper_descs(jax_config(ARCH, reduced=True)))
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
    """The f32 prefill of one 62-token prompt in both packages: (frames,
    tokens, JAX logits, JAX cache, port logits, port cache)."""
    jm, jp, tm, tp, jprefill = models["float32"]
    frames, toks = _frames(), _tokens(P + 3, seed=2)
    jb, tb = _inputs(frames, toks[:, :P], "float32")
    with mesh:
        jl, jc = jprefill(jp, jb)
    FK.KERNEL.reset_counts()
    tl, tc = tm.prefill(tp, tb)
    assert FK.KERNEL.launches == 0
    return frames, toks, jl, jc, tl, tc


@pytest.fixture(scope="module")
def jax_grads(models, mesh):
    """``jax.value_and_grad`` of the reference's f32 ``whisper_loss`` on
    (params, batch), jitted once."""
    cfg = models["float32"][0].cfg
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JW.whisper_loss(p, b, cfg, mesh, ())))

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


def _batch(cfg, step=0, S=24, dtype="float32"):
    """The reference's batch with stub frames, as JAX arrays and as torch
    tensors."""
    jb = dict(JDATA.batch_at(step, cfg, B, S, seed=0))
    frames = _frames(seed=11 + step)
    jb["frames"] = jnp.asarray(frames, jnp.dtype(dtype))
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k in ("tokens", "targets") else np.float32))
        for k, v in jb.items()}
    tb["frames"] = tb["frames"].to(getattr(torch, dtype))
    return jb, tb


def test_params_cross_and_the_layout(models):
    """Every leaf of the reference's tree crosses bit for bit, in the
    reference's layout (encoder and decoder blocks stacked (L, ...), a
    64-row decoder position table at REDUCED's vocabulary of 256) and
    dtypes, and the reference's own init makes the same tree of shapes
    and dtypes."""
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
    assert tuple(tp["pos_dec"].shape) == (64, D_MODEL)
    assert tuple(tp["pos_enc"].shape) == (F, D_MODEL)
    assert tuple(tp["decoder"]["xattn"]["q"]["w"].shape) == (2, 64, 64)
    assert tuple(tp["encoder"]["ffn"]["up"]["b"].shape) == (2, 128)
    assert count_params(tm.param_descs()) == sum(a.size for a in lj.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_jax(dtype):
    """Cross attention's plain softmax attention (GQA, Sq != Sk): f32
    within 2e-5; bf16, where p is rounded to v's dtype before p . v as the
    reference rounds it, within 1e-2 of the largest output and equal to
    the reference's bf16 output in at least 95 % of its elements (K6's
    rounding of the unnormalised exp(s - m) differs in ~47 % of them)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, F, 2, 16)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(JA.full_attention)(*(jnp.asarray(a, jdt)
                                        for a in (q, k, v)))
    got = A.full_attention(*(torch.from_numpy(a).to(tdt)
                             for a in (q, k, v)))
    assert got.dtype == tdt
    _close(got, want, TOL if dtype == "float32" else 1e-2, what=dtype)
    if dtype == "bfloat16":
        assert np.mean(to_np(got) != to_np(want)) <= 0.05


def test_noncausal_chunked_attention_matches_jax():
    """``chunked_attention(causal=False)`` (on the CPU, K6's plain
    version) against the reference's ``chunked_attention(causal=False)``,
    GQA with group 2, over 32 frames."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, F, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, F, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(lambda *a: JA.chunked_attention(
        *a, causal=False, q_chunk=16, kv_chunk=16))(
            *(jnp.asarray(a) for a in (q, k, v)))
    got = A.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
    _close(got, want, what="non-causal")
    causal = A.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert float((causal - got).abs().max()) > 1e-2


def test_encode_matches_jax(models):
    """The encoder over stub frames (full self-attention, no rope), in
    f32."""
    jm, jp, tm, tp, _ = models["float32"]
    frames = _frames(seed=9)
    want = jax.jit(lambda p, f: JW.encode(p, f, jm.cfg))(
        jp, jnp.asarray(frames))
    got = W.encode(tp, torch.from_numpy(frames), tm.cfg)
    _close(got, want, what="encode")


def test_prefill_logits_and_cache_match_jax(prefilled):
    """Prefill over 62 tokens: the logits and every cache leaf (per layer
    the self-attention's k, v over the prompt and the cross attention's
    xk, xv over the frames) within 2e-5; no kernel launches on the
    CPU."""
    _, _, jl, jc, tl, tc = prefilled
    assert tl.shape == (B, 256) and len(tc) == len(jc) == 2
    _close(tl, jl, what="logits")
    for i, (t, j) in enumerate(zip(tc, jc)):
        assert set(t) == set(j) == {"k", "v", "xk", "xv"}
        assert tuple(t["k"].shape) == (B, P, 4, 16)
        assert tuple(t["xk"].shape) == (B, F, 4, 16)
        for n in t:
            _close(t[n], j[n], what=(i, n))


def test_decode_three_steps_match_jax(models, prefilled, mesh):
    """The 62-token prefill spliced into a 72-row cache (k, v along the
    sequence; xk, xv whole), then three decode steps at positions 62, 63
    and 64 fed the same tokens (the last past the 64-row position table,
    which it reads clipped to row 63): logits and every cache leaf agree
    each step; and the last step's logits equal a prefill over all 65
    tokens."""
    jm, jp, tm, tp, _ = models["float32"]
    frames, toks, _, jpc, _, tpc = prefilled
    tc = TS.build_cache(tm, tpc, B, CACHE)
    assert tuple(tc[0]["k"].shape) == (B, CACHE, 4, 16)
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
            for layer, (t, j) in enumerate(zip(tc, jc)):
                for n in t:
                    _close(t[n], j[n], what=(i, layer, n))
    assert P + 2 >= tp["pos_dec"].shape[0]
    _, tb = _inputs(frames, toks, "float32")
    full, _ = tm.prefill(tp, tb)
    _close(tl, full, 1e-4, what="decode vs prefill")


def test_loss_and_grads_match_jax(models, jax_grads):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``whisper_loss`` (the encoder's non-causal attention
    and the decoder's causal and cross attention carry gradient)."""
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
    frames, toks = _frames(seed=13), _tokens(24, seed=5)
    want, j16 = None, None
    with mesh:
        for d in ("float32", "bfloat16"):
            jb, _ = _inputs(frames, toks, d)
            out = np.asarray(models[d][4](models[d][1], jb)[0], np.float32)
            want, j16 = (out, j16) if d == "float32" else (want, out)
    _, _, tm, tp, _ = models["bfloat16"]
    _, tb = _inputs(frames, toks, "bfloat16")
    t16 = to_np(tm.prefill(tp, tb)[0])
    err = lambda a: float(np.abs(a - want).max()) / float(np.abs(want).max())
    assert err(t16) <= 1.5 * err(j16), (err(t16), err(j16))


def _grad_errs(grads, ref):
    """{leaf: max |g - g_ref| / max |g_ref|}."""
    g, r = leaves(grads), leaves(ref)
    return {"/".join(p): float(np.abs(to_np(g[p]) - to_np(r[p])).max())
            / max(float(np.abs(to_np(r[p])).max()), 1e-30) for p in r}


def test_bf16_grads_hold_the_rule_against_jax(models, jax_grads, mesh,
                                              tmp_path):
    """bf16 loss gradients on the f32 weights rounded, against JAX's f32
    gradients, over four draws of the weights: the reference's own init
    under PYTHONHASHSEED 0, 1 and 13, perturbed, and the numpy draw of
    the other tests. Over the draws and leaves, the port's worst max |g -
    g_f32| / max |g_f32| is no more than 1.5 x JAX's bf16 worst; and for
    every leaf the geometric mean over the draws of the port's error over
    JAX's is at most 1.5. Each draw's worst leaves are printed (``-s``)."""
    inits = reference_inits(ARCH, "repro.models.whisper:whisper_descs",
                            tmp_path, HASH_SEEDS)
    jm, _, _, _, _ = models["float32"]
    jm16, jp16, tm16, _, _ = models["bfloat16"]
    jb, tb = _batch(jm.cfg)
    jb16, tb16 = _batch(jm.cfg, dtype="bfloat16")
    with mesh:        # compiled while the inits run
        vg16 = jax.jit(jax.value_and_grad(
            lambda p, b: JW.whisper_loss(p, b, jm16.cfg, mesh, ()))).lower(
                jp16, jb16).compile()
    draws = {f"init, PYTHONHASHSEED {s}": perturbed(t)
             for s, t in inits().items()}
    draws["numpy draw 0"] = numpy_params(
        JW.whisper_descs(jax_config(ARCH, reduced=True)))
    port, ref = [], []
    for name, tree in draws.items():
        _, g32 = jax_grads(jax_params(jm, tree), jb)
        with mesh:
            _, g16 = vg16(jax_params(jm16, tree), jb16)
        _, t16 = ST.loss_and_grads(
            tm16, lm_params_from_numpy(tree, tm16.cfg, device="cpu"), tb16)
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
    """Under ``remat="full"`` each decoder block is recomputed in the
    backward: the loss and every gradient equal the stored-activation
    run's bit for bit."""
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


def test_modality_stub_frames():
    """``add_modality_stub`` gives the encdec family frames of the
    reference's shape and dtype at the stub's scale, on the tokens'
    device; the same (seed, step) draws the same frames, another step
    other ones; the ssm family takes the batch unchanged and the vlm
    family gets patches, not frames."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = configs(ARCH, dtype)
        tokens = torch.zeros(3, 5, dtype=torch.int64)
        got = DATA.add_modality_stub({"tokens": tokens}, cfg, 4, seed=2)
        want = JDATA.add_modality_stub({"tokens": jnp.zeros((3, 5),
                                                            jnp.int32)},
                                       jcfg, 4, seed=2)
        f = got["frames"]
        assert tuple(f.shape) == tuple(want["frames"].shape) == (3, F, 64)
        assert str(f.dtype) == f"torch.{want['frames'].dtype}"
        assert f.device == tokens.device
        assert 0.015 < float(f.float().std()) < 0.025
        again = DATA.add_modality_stub({"tokens": tokens}, cfg, 4, seed=2)
        assert torch.equal(again["frames"], f)
        other = DATA.add_modality_stub({"tokens": tokens}, cfg, 5, seed=2)
        assert not torch.equal(other["frames"], f)
    rwkv = get_config("rwkv6-3b", reduced=True)
    assert set(DATA.add_modality_stub({"tokens": tokens}, rwkv, 0)) == {
        "tokens"}
    llava = get_config("llava-next-mistral-7b", reduced=True)
    assert set(DATA.add_modality_stub({"tokens": tokens}, llava, 0)) == {
        "tokens", "patches"}


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
    """Every field of the full config (the encoder-decoder sub-config
    too) equals the reference's, and so does the parameter count from the
    descriptors alone, part by part, with nothing allocated: nothing is
    cut, 4 + 4 layers at d 384 over 1500 frames."""
    ref, port = jax_config(ARCH), get_config(ARCH)
    for f in port.__dataclass_fields__:
        want, got = getattr(ref, f), getattr(port, f)
        if f == "encdec":
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    descs = Model(port, device="cpu").param_descs()
    assert count_params(descs) == jax_count_params(JW.whisper_descs(ref)) \
        == 58_528_512
    assert [count_params(descs[k]) for k in ("encoder", "decoder", "embed",
                                             "pos_dec", "pos_enc")] \
        == [7_091_712, 9_454_080, 39_832_320, 1_572_864, 576_000]
    assert port.resolved_head_dim == 64 and port.remat == "full"
