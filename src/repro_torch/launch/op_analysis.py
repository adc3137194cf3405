"""Op-level cost analysis of one step: the counterpart of the reference's
``repro.launch.hlo_analysis``.

The reference parses the optimized HLO of a compiled step and weights
every computation by its loops' trip counts. The port has no HLO: a step
is a sequence of eager aten ops. :class:`OpAnalysis` is a
``TorchDispatchMode`` that sees every aten op the step dispatches (the
backward's too) and counts, under the reference's result keys:

* ``flops`` — 2 x |result| x |contracting dims| for every product: the
  aten ops an XLA ``dot`` becomes (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``; ``matmul``, ``einsum`` and
  ``linear`` lower to them). Nothing else is counted, as the reference
  counts ``dot`` only. A product the port writes as a multiply and a sum
  is not a product here, and one the reference writes as a ``dot`` is
  one there: the two counts differ by exactly such ops
  (``tests/test_torch_dryrun.py`` pins the two known cases).
* ``bytes`` — operand bytes plus result bytes of every op that is not a
  view or an allocation, by the reference's rule: copy-like ops
  (copies, casts, gathers, slicing writes, pads) move twice their
  result's bytes, the others read their operands and write their
  result. Eager torch fuses nothing, so this is the eager program's
  traffic; it is not held equal to the reference's count, which is
  taken after XLA's fusion.
* ``collective_bytes``, ``collective_counts``, ``collective_total`` —
  empty and 0: every mesh of the port is emulated on one device
  (``launch.mesh.EmulatedMesh``), so a step issues no collective.
* ``f32_artifact_bytes`` — bytes of the f32 tensor shapes the step
  creates that are also the shape of a bf16 tensor it holds, each
  distinct shape once (the reference's rule). In the reference these
  are XLA:CPU's upcasts of bf16 buffers; in the port there is no
  compiler, so they are the step's own f32 widening (``flash_decode``
  widens the cache, the plain attention and the norms widen their
  inputs).
* ``peak_live_bytes`` — the largest sum of the bytes of live storages
  during the step: the step's inputs (for the whole step) and every
  op's output from its creation until its last reference dies. This
  stands in for XLA's ``memory_analysis()``. Storages are keyed by
  their Python object (PyTorch keeps one per storage), since a
  ``meta`` tensor has no data pointer, and freed by ``weakref.finalize``.

Run the step on ``meta`` tensors (``models.param.abstract``) and nothing
is allocated: on ``meta`` every wrapper runs its kernel's plain version,
as on the CPU (``kernels.dispatch``), so the counts are those of the
plain program (the plain attention's score chunks, not K6 / K7's tiles).
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten

# product op -> the position of its left operand: its FLOPs are 2 x
# |result| x the left operand's last (contracted) dimension
PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
            _aten.addmm: 1, _aten.baddbmm: 1, _aten.addmv: 1}

# the reference's result-proportional ops (slice, gather, dynamic-update-
# slice, scatter, pad, broadcast, reshape, transpose, copy, convert): twice
# the result's bytes
COPY_LIKE = {
    _aten._to_copy, _aten.clone, _aten.copy_, _aten.copy,
    _aten.index, _aten.index_select, _aten.gather, _aten.constant_pad_nd,
    _aten.expand_copy, _aten._unsafe_view, _aten.repeat,
    _aten.slice_scatter, _aten.select_scatter, _aten.index_put,
    _aten.index_put_, _aten.scatter, _aten.scatter_,
}

# allocations and metadata: no traffic
NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten.detach,
    _aten.lift_fresh, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.is_same_size, _aten._local_scalar_dense,
}


def _tensors(tree) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpAnalysis(TorchDispatchMode):
    """Count a step's products, bytes, f32 widening and live bytes.

    ``inputs``: the step's arguments (any tree of tensors); their storages
    count as live for the whole step. Use as a context manager around
    the step, then read :meth:`result`.
    """

    def __init__(self, inputs: Any = None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self._bf16_shapes: set = set()
        self._f32_shapes: set = set()
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        for t in _tensors(inputs):
            self._track(t)

    # -- live storages -------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        weakref.finalize(s, self._free, key)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    # -- the mode ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops += 1
        if packet in PRODUCTS:
            self.flops += (2 * outs[0].numel()
                           * args[PRODUCTS[packet]].shape[-1])
        if not (func.is_view or packet in NO_TRAFFIC):
            res = sum(_nbytes(t) for t in outs)
            if packet in COPY_LIKE:
                self.bytes += 2 * res
            else:
                self.bytes += res + sum(_nbytes(t) for t in ins)
        for t in ins + outs:
            if t.dtype == torch.bfloat16 and t.dim():
                self._bf16_shapes.add(tuple(t.shape))
        for t in outs:
            if t.dtype == torch.float32 and t.dim():
                self._f32_shapes.add(tuple(t.shape))
            self._track(t)
        return out

    def f32_artifact_bytes(self) -> int:
        return sum(4 * math.prod(s) for s in self._f32_shapes
                   if s in self._bf16_shapes)

    def result(self) -> Dict[str, Any]:
        """The reference's ``analyze_hlo`` keys, plus
        ``f32_artifact_bytes``, ``peak_live_bytes`` and ``ops``."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": {}, "collective_counts": {},
                "collective_total": 0.0,
                "f32_artifact_bytes": self.f32_artifact_bytes(),
                "peak_live_bytes": int(self.peak_live_bytes),
                "ops": self.ops}
