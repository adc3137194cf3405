"""Parameter descriptors: one tree of ``ParamDesc`` gives each parameter's
shape, dtype, logical sharding axes and initializer. From that one tree
come random tensors on a device (:func:`materialize`), ``meta`` stand-ins
of each leaf's shape and dtype for the dry run (:func:`abstract`), and
each leaf's partition spec over a mesh (:func:`partition_specs`).

Logical axes map to mesh axes by :class:`LogicalRules`, the reference's
rules (``repro.models.param``): a mapping that does not divide the
dimension evenly is dropped, so that dimension is replicated. There is
no ``NamedSharding`` in torch: where the reference returns shardings,
the port returns the specs, one tuple per leaf with one entry per
dimension (``None``, one mesh-axis name, or a tuple of names: the
entries of the reference's ``PartitionSpec``). Every mesh of the port is
emulated on one device (``launch.mesh.EmulatedMesh``), so the specs lay
nothing out; the dry run reads them for each device's share of the
bytes.

The init rules are the reference's (``repro.models.param._init_leaf``):
"normal" is N(0, 1) times ``min(scale, 1/sqrt(fan_in))`` with ``fan_in``
the leaf's first dimension; "embed" is N(0, 1) times ``scale``; "ones",
"zeros" and "const" (every element ``const``) are what they say. The random bits come from the
caller's ``torch.Generator`` and do not reproduce JAX's (the reference
folds a per-process salted ``hash`` of the path into its key); weights
cross from the reference as numpy (``repro_torch.convert``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

Tree = Any
AxisName = Optional[str]
# one dimension's entry of a partition spec: replicated, one mesh axis, or
# several
SpecEntry = Union[None, str, Tuple[str, ...]]

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
    axes: Tuple[AxisName, ...] = ()
    init: str = "normal"      # normal | zeros | ones | embed | const
    scale: float = 0.02
    const: float = 0.0        # the value of an init="const" leaf

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def leaf_paths(tree: Tree, prefix=()):
    """(path, desc) of every leaf, dict keys in sorted order (the
    reference's ``_leaf_paths``)."""
    if isinstance(tree, ParamDesc):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (str(i),))
    elif tree is not None:
        raise TypeError(f"bad desc tree node {type(tree)}")


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


def abstract(descs: Tree) -> Tree:
    """A ``meta`` tensor of each leaf's shape and dtype (no storage): the
    counterpart of the reference's ``ShapeDtypeStruct`` stand-ins."""
    return tree_map_descs(
        lambda p, d: torch.empty(d.shape, dtype=torch_dtype(d.dtype),
                                 device="meta"), descs)


@dataclass(frozen=True)
class LogicalRules:
    """logical axis -> tuple of mesh axes (in order of preference)."""

    rules: Dict[str, Tuple[str, ...]]
    mesh_axis_sizes: Dict[str, int]

    def spec_for(self, d: ParamDesc) -> Tuple[SpecEntry, ...]:
        """One entry per dimension of ``d``; ``()`` for a leaf without
        axes (replicated), as the reference's ``P()``. A mesh axis shards
        a dimension only if the product so far divides it, and each mesh
        axis is used once per leaf."""
        if not d.axes:
            return ()
        parts = []
        used: set = set()
        for dim, ax in zip(d.shape, d.axes):
            if ax is None or ax not in self.rules:
                parts.append(None)
                continue
            assigned = []
            prod = 1
            for mesh_ax in self.rules[ax]:
                if mesh_ax in used or mesh_ax not in self.mesh_axis_sizes:
                    continue
                sz = self.mesh_axis_sizes[mesh_ax]
                if dim % (prod * sz) == 0:
                    assigned.append(mesh_ax)
                    prod *= sz
            used.update(assigned)
            parts.append(assigned[0] if len(assigned) == 1
                         else tuple(assigned) if assigned else None)
        return tuple(parts)

    def replace(self, **rules: Tuple[str, ...]) -> "LogicalRules":
        """These rules with some logical axes mapped anew."""
        return LogicalRules({**self.rules, **rules}, self.mesh_axis_sizes)


def default_rules(mesh) -> LogicalRules:
    """The reference's rules over ``mesh`` (an ``EmulatedMesh``): batch
    over (pod, data), FSDP over data (and pod), tensor parallelism,
    vocabulary, experts and the decode cache's sequence over model."""
    sizes = mesh.shape
    batch_axes = ("pod", "data") if "pod" in sizes else ("data",)
    return LogicalRules(
        rules={
            "batch": batch_axes,
            "embed": ("data", "pod"),      # FSDP dims for params (zero-3)
            "embed_pod": ("pod", "data"),  # FSDP over pod too (XXL models)
            "model": ("model",),           # TP dim (flattened heads*dim / ff)
            "vocab": ("model",),
            "experts": ("model",),
            "kv_seq": ("model",),          # decode cache sequence sharding
            "seq": (),                     # unsharded by default in train
        },
        mesh_axis_sizes=sizes,
    )


def partition_specs(descs: Tree, rules: LogicalRules) -> Tree:
    return tree_map_descs(lambda p, d: rules.spec_for(d), descs)


def shard_shape(shape: Tuple[int, ...], spec: Tuple[SpecEntry, ...],
                mesh_axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The per-device block of a leaf of ``shape`` laid out by ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        out[i] //= math.prod(mesh_axis_sizes[n] for n in names)
    return tuple(out)


def count_params(descs: Tree) -> int:
    return sum(int(np.prod(d.shape)) for _, d in leaf_paths(descs))


def bytes_of(descs: Tree) -> int:
    return sum(int(np.prod(d.shape)) * torch_dtype(d.dtype).itemsize
               for _, d in leaf_paths(descs))
