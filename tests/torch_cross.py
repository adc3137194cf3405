"""Language-model parameters carried from the JAX package to the port, for
the differential tests of the model families.

The reference's own init folds a per-process salted ``hash`` of each
path into its key, so its draws change from process to process; the
tests therefore draw the tree with numpy from the reference's
descriptors (:func:`numpy_params`, one fixed seed) and hand both packages
the same arrays (``convert.lm_params_from_numpy``). Leaves the reference
initialises to all zeros or all ones (the ``qkv_bias`` biases, the
rms-norm scales, the sigmoid router's ``bias``) would hide a port that
drops or misplaces them, so the draw moves each by N(0, 0.1^2) noise;
:func:`perturbed` does the same to a tree of the reference's own init,
and :func:`reference_inits` runs that init under several
``PYTHONHASHSEED`` salts, one process each (the hybrid, ssm and encdec
tests).

The train-step tests hold the port's optimizer step with
:func:`spy_on_apply` and :func:`hold_step`: the gradients the port's step
used against the reference's at the same parameters, and the port's
parameters and moments after the step against the reference's AdamW
applied to those same gradients. Held against the reference's whole
trajectory instead, an element whose gradient sits near AdamW's eps turns
f32 rounding of its gradient into a parameter difference of ~1e-3 of the
learning rate.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.optim import adamw as JADAMW
from repro.models.param import tree_map_descs as jax_tree_map_descs
from repro.models.registry import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.registry import Model
from repro_torch.optim import adamw

F32 = dict(dtype="float32", param_dtype="float32")
DTYPES = {"float32": F32, "bfloat16": {}}


def perturbed(tree, seed: int = 0):
    """A copy of a numpy tree in which every all-zero or all-one leaf has
    N(0, 0.1^2) noise added (in f32, then rounded to the leaf's dtype)."""
    rng = np.random.default_rng(seed)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        a = np.asarray(node)
        f = a.astype(np.float32)
        if f.size and (np.all(f == 0) or np.all(f == 1)):
            f = f + 0.1 * rng.standard_normal(f.shape).astype(np.float32)
            return f.astype(a.dtype)
        return a
    return rec(tree)


def leaves(tree):
    """{path: leaf} of a nested dict."""
    return dict(zip(adamw.paths(tree), adamw.leaves(tree)))


def configs(arch: str, dtype: str, moe=None, **changes):
    """(reference config, port config) of ``arch`` at REDUCED width in
    ``dtype``, with ``changes`` applied to both and ``moe`` (a dict) to
    both MoE sub-configs."""
    kw = dict(DTYPES[dtype], **changes)
    out = []
    for c in (jax_config(arch, reduced=True), get_config(arch,
                                                         reduced=True)):
        if moe:
            kw["moe"] = dataclasses.replace(c.moe, **moe)
        out.append(c.replace(**kw))
    return tuple(out)


def shapes(tree):
    """{path: (shape, dtype)} of a nested tree of arrays or shape
    structs."""
    return {p: (tuple(v.shape), str(v.dtype)) for p, v in leaves(tree).items()}


def cross(arch: str, dtype: str, mesh, moe=None, **changes):
    """(JAX model, its params, the port's Model on the CPU, the same
    params carried across) for ``arch`` at REDUCED width in ``dtype``,
    with ``changes`` (and ``moe``, see :func:`configs`) applied to both
    configurations: the numpy draw :func:`numpy_params` of the
    reference's descriptors (the unit leaves perturbed), each leaf in its
    descriptor's dtype, so every process gets the same weights. The tree
    has the shapes and dtypes of the reference's own init."""
    jcfg, cfg = configs(arch, dtype, moe, **changes)
    jm = jax_model(jcfg, mesh)
    tree = numpy_params(jm.param_descs())
    jp = jax_params(jm, tree)
    assert shapes(jax.eval_shape(jm.init, jax.random.key(0))) == shapes(jp)
    return (jm, jp, Model(cfg, device="cpu"),
            lm_params_from_numpy(tree, cfg, device="cpu"))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def numpy_params(descs, seed: int = 0):
    """The reference's parameter tree of the descriptors ``descs`` (its
    family's ``*_descs(cfg)``) drawn with numpy at its init scales:
    "normal" N(0, 1) times min(scale, fan_in ** -0.5), "embed" times
    scale, and the unit and constant leaves (zeros, ones, A_log's 0,
    rwkv6's decay_base -4) moved by N(0, 0.1^2) noise, so a port that
    drops one shows. (The reference's own init salts its keys with a
    per-process ``hash``, so its draws change from run to run.)"""
    rng = np.random.default_rng(seed)

    def draw(path, d):
        a = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "normal":
            fan_in = d.shape[0] if len(d.shape) >= 2 else 1
            return a * min(d.scale or 1.0, fan_in ** -0.5)
        if d.init == "embed":
            return a * d.scale
        base = {"ones": 1.0, "zeros": 0.0, "const": d.const}[d.init]
        return base + 0.1 * a
    return jax_tree_map_descs(draw, descs)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_params(jm, tree):
    """The numpy ``tree`` as the reference's parameters of ``jm``, each
    leaf in its descriptor's dtype."""
    return jax_tree_map_descs(
        lambda path, d: jnp.asarray(_at(tree, path), d.dtype),
        jm.param_descs())


_INIT = """
import importlib, os, sys
os.nice(10)      # yield the cores to the test processes running beside it
import jax, numpy as np
from repro.configs import get_config
from repro.models.param import materialize
mod, fn = sys.argv[2].split(":")
descs = getattr(importlib.import_module(mod), fn)
cfg = get_config(sys.argv[1], reduced=True).replace(
    dtype="float32", param_dtype="float32")
flat = {}
def walk(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(node)
walk(materialize(descs(cfg), jax.random.key(0)), ())
np.savez(sys.argv[3], **flat)
"""


def reference_inits(arch: str, descs: str, out_dir, seeds):
    """Start the reference's own f32 init of ``arch`` at REDUCED width
    (``materialize`` of ``descs``, "module:function" of its family's
    descriptors, key 0) in one process per PYTHONHASHSEED of ``seeds``,
    all at once: its init folds the per-process ``hash`` of each leaf's
    path into the leaf's key, so each salt is another draw. Returns a
    function that waits for them and gives {seed: nested numpy tree}."""
    import repro.models.param as jax_param
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(Path(jax_param.__file__).parents[2]))
    runs = {s: subprocess.Popen(
        [sys.executable, "-c", _INIT, arch, descs,
         str(Path(out_dir) / f"{s}.npz")],
        env=dict(env, PYTHONHASHSEED=str(s))) for s in seeds}

    def collect():
        trees = {}
        for s, run in runs.items():
            assert run.wait(timeout=300) == 0, s
            tree = trees[s] = {}
            with np.load(Path(out_dir) / f"{s}.npz") as z:
                for name in z.files:
                    *head, last = name.split("/")
                    node = tree
                    for k in head:
                        node = node.setdefault(k, {})
                    node[last] = z[name]
        return trees
    return collect


def assert_tree_close(got, want, tol, scale=None, what="", global_for=()):
    """Every leaf of ``got`` within ``tol`` of ``scale`` of ``want``'s
    (default: the leaf's largest element, at least 1e-30; for the paths
    in ``global_for``, the largest element of the whole tree)."""
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), what
    top = max(float(np.abs(to_np(x)).max(initial=0.0)) for x in w.values())
    for path in w:
        a, b = to_np(g[path]), to_np(w[path])
        assert a.shape == b.shape, (what, path)
        s = scale if scale is not None else max(float(np.abs(b).max(
            initial=0.0)), 1e-30)
        if path in global_for:
            s = top
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= tol * s, f"{what} {'/'.join(path)}: {err} > {tol} * {s}"


def spy_on_apply(monkeypatch):
    """A list that receives, at each call of the port's ``adamw.apply``
    (the optimizer step inside ``launch.steps.make_train_step``), copies
    of its (params, grads, opt state)."""
    seen = []
    real = adamw.apply
    copy = lambda tree: adamw.tree_map(lambda t: t.detach().clone(), tree)

    def spy(params, grads, opt, cfg, lr, inplace=False):
        seen.append((copy(params), copy(grads), adamw.OptState(
            opt.step.clone(), copy(opt.mu), copy(opt.nu))))
        return real(params, grads, opt, cfg, lr, inplace=inplace)
    monkeypatch.setattr(adamw, "apply", spy)
    return seen


def hold_step(state, inputs, japply, ref_grads, grad_tol, lr, what="",
              global_for=()):
    """The port's f32 train step, element by element. ``inputs``: the
    (params, grads, opt state) it passed to ``adamw.apply``
    (:func:`spy_on_apply`); ``state``: the state it returned. The port's
    gradients within ``grad_tol`` (of each leaf's largest element, or the
    tree's for ``global_for``) of ``ref_grads(params)``, the reference's
    gradients at the same parameters (as JAX arrays); the parameters
    within 1e-3 of ``lr`` and mu and nu within 1e-4 of their largest
    element of ``japply(params, grads, opt)``, the reference's AdamW step
    (jitted, its ``lr_at`` of the step) on the port's own gradients."""
    params, grads, opt = inputs
    assert all(t.dtype == torch.float32 for t in adamw.leaves(params))
    j = lambda tree: adamw.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    assert_tree_close(grads, ref_grads(j(params)), grad_tol,
                      what=f"{what} grad", global_for=global_for)
    want, wopt, _ = japply(j(params), j(grads), JADAMW.OptState(
        jnp.asarray(opt.step.numpy()), j(opt.mu), j(opt.nu)))
    assert_tree_close(state["params"], want, 1e-3, scale=lr,
                      what=f"{what} params")
    assert_tree_close(state["opt"].mu, wopt.mu, 1e-4, what=f"{what} mu")
    assert_tree_close(state["opt"].nu, wopt.nu, 1e-4, what=f"{what} nu")
