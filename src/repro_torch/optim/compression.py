"""Gradient compression for cross-pod data parallelism (the port of
``repro.optim.compression``).

int8 error-feedback compression: gradients are quantized per leaf to int8
with one f32 scale per leaf before the all-reduce; the quantization
residual is carried in an error-feedback buffer, so the compression bias
vanishes over steps. The arithmetic is the reference's compiled
arithmetic, bit for bit: f32 throughout, rounding half to even, the
residual rounded once (:func:`_quantize`).

The reference runs :func:`compressed_psum` inside ``shard_map``, one
call per rank. The port has no ``shard_map``: it emulates the ranks on
one device, so a leaf passed to :func:`compressed_psum` holds every
rank's copy stacked on a leading dim, one row per rank of the emulated
``axis_names`` (the product of their sizes in an
:class:`~repro_torch.launch.mesh.EmulatedMesh`), in the reference's
row-major rank order.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch

from repro_torch.optim.adamw import tree_map

Tree = Any
CHUNK = 1 << 24          # elements per slice of the residual's f64 pass


def init_error(params: Tree) -> Tree:
    """Zero f32 error-feedback buffers shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor, scale: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, residual x - q * scale) of the f32 ``x`` at ``scale``.
    The residual is rounded to f32 once, as the reference's compiled step
    computes it (XLA fuses the product into the subtraction): q * scale
    (7 + 24 bits) and its difference to x (within a factor of 2 of each
    other when q != 0) are exact in f64, computed in slices of CHUNK
    elements so the f64 temporaries stay small beside a large leaf."""
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    resid = torch.empty_like(x)
    flat_x, flat_q, flat_r = x.reshape(-1), q.reshape(-1), resid.view(-1)
    s = scale.double()
    for i in range(0, flat_x.numel(), CHUNK):
        sl = slice(i, i + CHUNK)
        flat_r[sl] = (flat_x[sl].double() - flat_q[sl].double() * s).float()
    return q, resid


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 q, f32 0-d scale, new f32 residual)."""
    x = g.float() + err
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q, resid = _quantize(x, scale)
    return q, scale, resid


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Tree, err: Tree, mesh,
                    axis_names: Union[str, Sequence[str]]
                    ) -> Tuple[Tree, Tree]:
    """All-reduce int8-quantized gradients over the emulated ranks of
    ``axis_names`` of ``mesh``: each leaf of ``grads`` and ``err`` is
    (n, ...), rank r's copy in row r, n the product of the axes' sizes.
    One scale per leaf is shared by the ranks (the reference's pmax of
    each rank's max |g + err|), so the int32 sum of the ranks' int8
    values dequantizes exactly. Returns (the f32 mean gradients, every
    rank's row equal; the new per-rank residuals), stacked as the
    inputs."""
    n = mesh.axis_size(axis_names)

    def one(g, e):
        if g.shape[0] != n:
            raise ValueError(
                f"a leaf of shape {tuple(g.shape)} does not stack the {n} "
                f"ranks of axes {axis_names!r} on its leading dim")
        x = g.float() + e
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        q, resid = _quantize(x, scale)
        tot = q.to(torch.int32).sum(0, dtype=torch.int32)
        g_hat = tot.float() * scale / n
        return g_hat.expand_as(x).clone(), resid

    out = tree_map(one, grads, err)
    return _pick(out, 0), _pick(out, 1)


def _pick(tree: Tree, i: int) -> Tree:
    """Element ``i`` of each (mean, residual) pair of a mapped tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
