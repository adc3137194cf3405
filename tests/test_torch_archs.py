"""The port's qwen3-14b, qwen1.5-32b, granite-20b, deepseek-v3-671b and
llama4-scout-17b-a16e against the JAX package on the CPU, at REDUCED
width, on the (1, 1) mesh.

Parameters cross as numpy with the unit leaves perturbed
(``torch_cross.perturbed``): qwen1.5's qkv biases, qwen3's q/k norms,
MLA's q/kv norms and the sigmoid router's bias would otherwise be zeros
and ones that a port could drop unseen. Tolerances as in
``tests/test_torch_lm.py``: 1e-5 in f32 (the same arithmetic summed in
another order), 2e-2 in bf16 for the dense configs; the moe configs are
held in f32 only, since a bf16 rounding difference can move a token to
another expert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import build_cache as jax_build_cache
from repro.launch.serve import serve as jax_serve
from repro.models import lm as JLM
from repro.models.param import count_params as jax_count_params
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as TS
from repro_torch.models.param import count_params
from repro_torch.models.registry import Model
from torch_cross import close, cross, leaves, to_np

DENSE = ["qwen3-14b", "qwen1.5-32b", "granite-20b"]
MOE = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]
ARCHS = DENSE + MOE
P, GEN, CACHE = 12, 6, 24

_MODELS = {}


def models(arch, dtype, mesh):
    """Cached per (arch, dtype): building the JAX model takes seconds."""
    if (arch, dtype) not in _MODELS:
        _MODELS[arch, dtype] = cross(arch, dtype, mesh)
    return _MODELS[arch, dtype]


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def _cases(dense_bf16: bool):
    out = [(a, "float32", 1e-5) for a in ARCHS]
    if dense_bf16:
        out += [(a, "bfloat16", 2e-2) for a in DENSE]
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_bitwise(mesh, arch, dtype):
    """Every leaf of the reference's tree (the segmented stacks, deepseek's
    mtp block) crosses bit for bit in the port's dtype, and the unit
    leaves were perturbed."""
    jm, jp, tm, tp = models(arch, dtype, mesh)
    lj, lt = leaves(jax.tree.map(np.asarray, jp)), leaves(tp)
    assert set(lj) == set(lt)
    for path, a in lj.items():
        t = lt[path]
        assert str(t.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(to_np(t), np.asarray(a, np.float32))
        if path[-1] in ("scale", "b", "bias"):
            assert not np.all(np.isin(np.asarray(a, np.float32), (0., 1.)))
    assert count_params(tm.param_descs()) == sum(a.size for a in lj.values())
    if arch == "deepseek-v3-671b":
        assert {"stack_0_dense", "stack_1_moe", "mtp"} <= set(tp)


@pytest.mark.parametrize("arch,dtype,tol", _cases(dense_bf16=True))
def test_prefill_logits_and_cache_match_jax(mesh, arch, dtype, tol):
    """A 40-token prompt (no tile multiple); the cache is {k, v} per layer,
    or MLA's latent {ckv, kr}."""
    jm, jp, tm, tp = models(arch, dtype, mesh)
    toks = _tokens(2, 40)
    with mesh:
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
            toks, jnp.int32)})
    FK.KERNEL.reset_counts()
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert FK.KERNEL.launches == 0
    assert tl.shape == (2, 256) and len(tc) == len(jc) == tm.cfg.num_layers
    close(tl, jl, tol)
    names = {"ckv", "kr"} if tm.cfg.mla else {"k", "v"}
    for a, b in zip(tc, jc):
        assert set(a) == set(b) == names
        for n in names:
            assert tuple(a[n].shape) == b[n].shape
            close(a[n], b[n], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(mesh, arch):
    """Prefill 12 tokens, splice into a 24-row cache, 4 decode steps fed
    the same tokens: logits and every cache row agree each step (the moe
    configs at C = 1 per expert, as the reference's decode)."""
    jm, jp, tm, tp = models(arch, "float32", mesh)
    toks = _tokens(2, P + 4, seed=2)
    with mesh:
        _, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
            toks[:, :P], jnp.int32)})
        jc = jax_build_cache(jm, jpc, 2, CACHE)
        step = jax.jit(lambda p, t, po, c: jm.decode(p, t, po, c, CACHE))
        _, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P])})
        tc = TS.build_cache(tm, tpc, 2, CACHE)
        for i in range(4):
            tok = toks[:, P + i:P + i + 1]
            pos = np.full(2, P + i)
            jl, jc = step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc)
            tl, tc = tm.decode(tp, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc)
            close(tl, jl, 1e-5)
            for a, b in zip(tc, jc):
                for n in a:
                    close(a[n], b[n], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_jax_serve(mesh, arch):
    jm, jp, tm, tp = models(arch, "float32", mesh)
    toks = _tokens(2, P, seed=3)
    want, _ = jax_serve(jm, jp, {"tokens": jnp.asarray(toks, jnp.int32)}, P,
                        GEN, CACHE)
    got, _ = TS.serve(tm, tp, {"tokens": torch.from_numpy(toks)}, P, GEN,
                      CACHE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_config_is_the_references(arch):
    """Every field of the full-width config (the MoE and MLA sub-configs
    too) equals the reference's, and so does the parameter count of the
    whole tree (deepseek-v3's mtp block included), from the descs alone."""
    ref, port = jax_config(arch), get_config(arch)
    for f in port.__dataclass_fields__:
        want, got = getattr(ref, f), getattr(port, f)
        if f in ("moe", "mla") and want is not None:
            assert vars(got) == vars(want), f
        else:
            assert got == want, f
    want = jax_count_params(JLM.lm_descs(ref))
    assert count_params(Model(port, device="cpu").param_descs()) == want
    assert want == {"qwen3-14b": 14_768_307_200,
                    "qwen1.5-32b": 35_197_096_960,
                    "granite-20b": 28_167_493_632,
                    "deepseek-v3-671b": 682_636_480_256,
                    "llama4-scout-17b-a16e": 107_769_861_888}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    toks = TS.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt", "8", "--gen", "3",
                    "--cache", "16"])
    assert tuple(toks.shape) == (2, 3)
    assert f"[serve] {arch}: generated (2, 3)" in capsys.readouterr().out
