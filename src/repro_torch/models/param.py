"""Parameter descriptors: one tree of ``ParamDesc`` gives each parameter's
shape, dtype and initializer, and :func:`materialize` turns it into
tensors on a device.

The init rules are the reference's (``repro.models.param._init_leaf``):
"normal" is N(0, 1) times ``min(scale, 1/sqrt(fan_in))`` with ``fan_in``
the leaf's first dimension; "embed" is N(0, 1) times ``scale``; "ones",
"zeros" and "const" (every element ``const``) are what they say. The random bits come from the
caller's ``torch.Generator`` and do not reproduce JAX's (the reference
folds a per-process salted ``hash`` of the path into its key); weights
cross from the reference as numpy (``repro_torch.convert``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import numpy as np
import torch

Tree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# elements of the largest f32 draw :func:`materialize` makes at once
DRAW_CHUNK = 1 << 30


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not supported; expected one of "
                         f"{list(DTYPES)}")
    return DTYPES[name]


@dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"      # normal | zeros | ones | embed | const
    scale: float = 0.02
    const: float = 0.0        # the value of an init="const" leaf


def tree_map_descs(fn: Callable[[Tuple[str, ...], ParamDesc], Any],
                   tree: Tree) -> Tree:
    """Map over ParamDesc leaves preserving structure (dicts/lists/None)."""
    def rec(node, prefix):
        if isinstance(node, ParamDesc):
            return fn(prefix, node)
        if isinstance(node, dict):
            return {k: rec(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        raise TypeError(f"bad desc tree node {type(node)}")
    return rec(tree, ())


def _init_leaf(d: ParamDesc, generator: torch.Generator,
               device) -> torch.Tensor:
    dtype = torch_dtype(d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "const":
        return torch.full(d.shape, d.const, dtype=dtype, device=device)
    if d.init == "embed":
        scale = d.scale
    elif d.init == "normal":
        fan_in = d.shape[0] if len(d.shape) >= 2 else 1
        scale = min(d.scale if d.scale else 1.0, 1.0 / np.sqrt(max(fan_in, 1)))
    else:
        raise ValueError(f"unknown init {d.init}")
    # drawn in f32 pieces of at most DRAW_CHUNK into the leaf's own dtype,
    # so a leaf as large as deepseek-v3's stacked experts (7.5e9 elements)
    # never needs 4 bytes for each of its elements at once; randn fills by
    # element count alone, so a leaf of one piece draws what randn(shape)
    # would, and a leaf of no elements draws nothing
    n = int(np.prod(d.shape))
    out = torch.empty(d.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(lo + DRAW_CHUNK, n)
        w = torch.randn(hi - lo, generator=generator, dtype=torch.float32,
                        device=device)
        flat[lo:hi] = (w * scale).to(dtype)
    return out


def materialize(descs: Tree, generator: torch.Generator, device) -> Tree:
    """Random parameters for ``descs`` on ``device``, drawn in the tree's
    order from ``generator`` (which must live on ``device``)."""
    return tree_map_descs(lambda p, d: _init_leaf(d, generator, device),
                          descs)


def count_params(descs: Tree) -> int:
    n = []
    tree_map_descs(lambda p, d: n.append(int(np.prod(d.shape))), descs)
    return sum(n)
