"""Language-model parameters carried from the JAX package to the port, for
the differential tests of the model families.

The reference materialises its parameters once (its init folds a
per-process salted ``hash`` of each path into its key, so it cannot be
regenerated); they cross as numpy (``convert.lm_params_from_numpy``).
Leaves the reference initialises to all zeros or all ones (the
``qkv_bias`` biases, the rms-norm scales, the sigmoid router's ``bias``)
would hide a port that drops or misplaces them, so :func:`perturbed`
moves each by N(0, 0.1^2) noise from one numpy seed before both packages
get the same arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
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


def cross(arch: str, dtype: str, mesh, moe=None, **changes):
    """(JAX model, its params, the port's Model on the CPU, the same
    params carried across) for ``arch`` at REDUCED width in ``dtype``,
    with ``changes`` (and ``moe``, see :func:`configs`) applied to both
    configurations and the unit leaves perturbed."""
    jcfg, cfg = configs(arch, dtype, moe, **changes)
    jm = jax_model(jcfg, mesh)
    tree = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    return (jm, jax.tree.map(jnp.asarray, tree), Model(cfg, device="cpu"),
            lm_params_from_numpy(tree, cfg, device="cpu"))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
