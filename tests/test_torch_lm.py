"""The port's granite-3-2b serving path against the JAX package on the CPU,
at REDUCED width (2 layers, d 64, 4/2 heads, head_dim 16, vocab 256).

Both packages get one numpy draw of the reference's parameter tree
(``torch_cross.cross``: the reference's own init salts its keys with a
per-process ``hash``, so its draws change from run to run). Tokens are
drawn with numpy. Tolerances: layers 1e-6 and
the model 1e-5 in f32 (the same arithmetic summed in another order);
2e-2 in bf16 (the two frameworks round at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import build_cache as jax_build_cache
from repro.launch.serve import serve as jax_serve
from repro.models import layers as JL
from repro.models.lm import lm_hidden as jax_lm_hidden
from repro_torch.configs import ModelConfig, get_config, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.models import layers as TL
from repro_torch.models.lm import lm_hidden
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from torch_cross import cross

ARCH = "granite-3-2b"
P, GEN, CACHE = 12, 6, 24


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def models(mesh):
    """dtype -> (JAX model, its params, the port's Model, the same params
    carried across)."""
    return {name: cross(ARCH, name, mesh) for name in ("float32",
                                                       "bfloat16")}


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


# ------------------------------------------------------------- layers ------

def test_rms_norm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    _close(TL.rms_norm({"scale": _t(scale)}, _t(x), 1e-5),
           JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5),
           1e-6)


@pytest.mark.parametrize("pos_shape", [(40,), (3, 1)])
def test_rotary_matches_jax(rng, pos_shape):
    """Both forms of apply_rotary: (S, half) tables from prefill positions
    and (B, 1, half) from per-sequence decode positions."""
    positions = rng.integers(0, 40, pos_shape).astype(np.float32)
    cj, sj = JL.rotary(jnp.asarray(positions), 16, 10000.0)
    ct, st = TL.rotary(_t(positions), 16, 10000.0)
    _close(ct, cj, 1e-6)
    _close(st, sj, 1e-6)
    x = rng.standard_normal((3, pos_shape[0] if len(pos_shape) == 1 else 1,
                             4, 16)).astype(np.float32)
    _close(TL.apply_rotary(_t(x), ct, st),
           JL.apply_rotary(jnp.asarray(x), cj, sj), 1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_matches_jax(rng, act):
    d, ff = 16, 32
    names = ("gate", "up", "down") if act == "silu" else ("up", "down")
    p = {}
    for n in names:
        shape = (ff, d) if n == "down" else (d, ff)
        p[n] = {"w": rng.standard_normal(shape).astype(np.float32) * 0.3}
        if act == "gelu":
            p[n]["b"] = rng.standard_normal(shape[1]).astype(np.float32)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    tp = jax.tree.map(_t, p)
    _close(TL.ffn(tp, _t(x), act), JL.ffn(jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(x), act), 1e-6)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_logits_match_jax(rng, tie):
    V, d = 32, 8
    p = {"tok": rng.standard_normal((V, d)).astype(np.float32)}
    if not tie:
        p["unembed"] = rng.standard_normal((d, V)).astype(np.float32)
    toks = rng.integers(0, V, (2, 5))
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    xt = TL.embed(tp, torch.from_numpy(toks))
    xj = JL.embed(jp, jnp.asarray(toks))
    _close(xt, xj, 0.0)
    _close(TL.logits_fn(tp, xt, tie), JL.logits_fn(jp, xj, tie), 1e-6)


# ------------------------------------------------------------ weights ------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_bitwise(models, dtype):
    jm, jp, tm, tp = models[dtype]
    leaves_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_t[path] = node
    walk(tp, ())
    assert len(leaves_j) == len(flat_t) == 11
    for path, a in leaves_j:
        t = flat_t[tuple(k.key for k in path)]
        assert str(t.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    assert count_params(tm.param_descs()) == sum(
        int(np.prod(a.shape)) for _, a in leaves_j)


def test_params_from_numpy_refuses_a_tree_that_differs(models):
    jm, jp, tm, _ = models["float32"]
    tree = jax.tree.map(np.asarray, jp)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    extra = dict(tree, bonus={"w": np.zeros(3, np.float32)})
    wrong = dict(tree, final_norm={"scale": np.ones(65, np.float32)})
    for bad, msg in ((missing, "leaves"), (extra, "leaves"),
                     (wrong, "shape")):
        with pytest.raises(ValueError, match=msg):
            lm_params_from_numpy(bad, tm.cfg, device="cpu")


# -------------------------------------------------------------- model ------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_prefill_logits_and_cache_match_jax(models, mesh, dtype, tol):
    """Prompt of 40 tokens (not a multiple of any tile)."""
    jm, jp, tm, tp = models[dtype]
    toks = _tokens(2, 40)
    with mesh:
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
            toks, jnp.int32)})
    FK.KERNEL.launches = 0
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert FK.KERNEL.launches == 0
    assert tl.shape == (2, 256) and len(tc) == len(jc) == 2
    _close(tl, jl, tol)
    for a, b in zip(tc, jc):
        for n in ("k", "v"):
            assert tuple(a[n].shape) == b[n].shape == (2, 40, 2, 16)
            _close(a[n], b[n], tol)


def test_teacher_forced_decode_matches_jax(models, mesh):
    """Prefill 12 tokens, splice into a 24-row cache, then 4 decode steps
    fed the same tokens: logits and every cache row agree each step."""
    jm, jp, tm, tp = models["float32"]
    toks = _tokens(2, P + 4, seed=2)
    with mesh:
        jl, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
            toks[:, :P], jnp.int32)})
        jc = jax_build_cache(jm, jpc, 2, CACHE)
        step = jax.jit(lambda p, t, po, c: jm.decode(p, t, po, c, CACHE))
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P])})
        tc = TS.build_cache(tm, tpc, 2, CACHE)
        for i in range(4):
            tok = toks[:, P + i:P + i + 1]
            pos = np.full(2, P + i)
            jl, jc = step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc)
            tl, tc = tm.decode(tp, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc)
            _close(tl, jl, 1e-5)
            for a, b in zip(tc, jc):
                for n in ("k", "v"):
                    _close(a[n], b[n], 1e-5)


def test_serve_tokens_equal_jax_serve(models, mesh):
    jm, jp, tm, tp = models["float32"]
    toks = _tokens(2, P, seed=3)
    want, _ = jax_serve(jm, jp, {"tokens": jnp.asarray(toks, jnp.int32)}, P,
                        GEN, CACHE)
    stats = {}
    got, tps = TS.serve(tm, tp, {"tokens": torch.from_numpy(toks)}, P, GEN,
                        CACHE, stats=stats)
    assert got.shape == (2, GEN) and tps > 0
    assert set(stats) == {"prefill_s", "decode_s"}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_consistent_with_forward(models, mesh):
    """The serving path is the training path: prefill logits equal a full
    forward's last position, and the decode step at position P equals a
    full forward over P + 1 tokens (port and reference alike)."""
    jm, jp, tm, tp = models["float32"]
    toks = _tokens(1, P + 1, seed=4)
    tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P])})
    tc = TS.build_cache(tm, tpc, 1, CACHE)
    dl, _ = tm.decode(tp, torch.from_numpy(toks[:, P:]),
                      torch.tensor([P]), tc)
    for n, logits in ((P, tl), (P + 1, dl)):
        h = lm_hidden(tp, {"tokens": torch.from_numpy(toks[:, :n])}, tm.cfg)
        full = TL.logits_fn(tp["embed"], h[:, -1:], True)[:, 0]
        _close(logits, full, 1e-5)
        with mesh:
            hj, _ = jax_lm_hidden(
                jp, {"tokens": jnp.asarray(toks[:, :n], jnp.int32)}, jm.cfg,
                mesh, ())
        _close(full, JL.logits_fn(jp["embed"], hj[:, -1:], True)[:, 0], 1e-5)


def test_serve_cli_and_registry_on_the_cpu(capsys):
    toks = TS.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt", "8", "--gen", "3", "--cache", "16"])
    assert tuple(toks.shape) == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out
    assert list_archs() == [ARCH, "qwen1.5-32b", "qwen3-14b", "granite-20b",
                            "zamba2-2.7b", "llava-next-mistral-7b",
                            "deepseek-v3-671b", "llama4-scout-17b-a16e",
                            "whisper-tiny", "rwkv6-3b"]
    with pytest.raises(KeyError, match="unknown arch 'llava'"):
        get_config("llava")
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == (
        40, 2048, 32, 8, 64, 8192, 49155)
    assert count_params(Model(full, device="cpu").param_descs()) == (
        2_533_531_648)
    unknown = ModelConfig(name="m", family="vision-encoder", num_layers=1,
                          d_model=8, num_heads=2, num_kv_heads=1,
                          d_ff=8, vocab_size=8)
    with pytest.raises(NotImplementedError, match="not a model family of "
                                                  "the reference") as err:
        Model(unknown, device="cpu")
    assert "dense, vlm, moe, hybrid, ssm, encdec" in str(err.value)


@pytest.mark.parametrize("init,shape", [("normal", (300, 7)),
                                        ("embed", (2101,)),
                                        ("normal", (4, 0, 8))])
def test_materialize_draws_a_leaf_in_pieces(monkeypatch, init, shape):
    """A leaf larger than DRAW_CHUNK is filled piece by piece, in order,
    from the caller's generator; one of no elements draws nothing."""
    from repro_torch.models import param as PM

    monkeypatch.setattr(PM, "DRAW_CHUNK", 512)
    desc = PM.ParamDesc(shape, dtype="float32", init=init, scale=0.5)
    drawn = torch.Generator().manual_seed(3)
    got = PM.materialize({"w": desc}, drawn, "cpu")["w"]
    gen = torch.Generator().manual_seed(3)
    n = int(np.prod(shape))
    want = torch.cat([torch.randn(min(512, n - lo), generator=gen)
                      for lo in range(0, n, 512)] + [torch.zeros(0)])
    scale = 0.5 if init == "embed" else min(0.5, shape[0] ** -0.5)
    assert got.shape == shape and got.dtype == torch.float32
    torch.testing.assert_close(got.view(-1), want * scale, rtol=0, atol=0)
    # the generator moved on by exactly the values drawn
    assert torch.equal(torch.randn(4, generator=drawn),
                       torch.randn(4, generator=gen))
