"""Pipeline parallelism over the "pod" axis, GPipe-style (the port of
``repro.distributed.pipeline``), emulated on one device.

Stages are layer ranges. The schedule is the reference's classic
(num_micro + num_stages - 1)-tick loop, bubble fraction (S - 1) / (M +
S - 1): at tick t stage s applies its layers to microbatch t - s, when
that microbatch exists, and hands the result to stage s + 1 for tick
t + 1; the last stage's outputs are gathered in microbatch order. The
reference runs one stage per device inside ``shard_map`` and moves the
activations with ``ppermute``; here every stage and every data shard of
an :class:`~repro_torch.launch.mesh.EmulatedMesh` runs on its one
device, one after another.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.optim.adamw import tree_map

Tree = Any


def pipeline_apply(stage_fn: Callable[[Tree, torch.Tensor, int],
                                      torch.Tensor],
                   stage_params: Tree, x: torch.Tensor, mesh,
                   axis: str = "pod", num_micro: int = 4) -> torch.Tensor:
    """Run ``x`` (B, S, d) through num_stages = |axis| pipeline stages.

    ``stage_params``: a tree whose leaves stack the stages' parameters on
    a leading dim of num_stages. ``stage_fn(params, x, stage_idx) -> x``.
    As under the reference's ``shard_map``, the batch is split over the
    mesh's other axes into equal local batches (contiguous rows, in the
    axes' row-major order), each local batch into ``num_micro``
    microbatches, and the outputs come back in the batch's order. The
    reference computes every (stage, tick) pair and discards the pairs
    whose microbatch is out of range; the emulation skips them, so each
    stage runs once per microbatch and local batch."""
    sizes = mesh.shape
    if axis not in sizes:
        raise ValueError(
            f"pipeline stage axis {axis!r} is not in mesh axes "
            f"{tuple(mesh.axis_names)}; the 2D DFA meshes name their pod "
            "axis 'pod' (launch.mesh.make_dfa_mesh / "
            "make_production_mesh(multi_pod=True))")
    n_stages = sizes[axis]
    B = x.shape[0]
    shards = math.prod(n for a, n in sizes.items() if a != axis)
    if B % num_micro or B % shards:
        raise ValueError(f"batch {B} does not split into {num_micro} "
                         f"microbatches over {shards} data shards")
    params = [tree_map(lambda a, s=s: a[s], stage_params)
              for s in range(n_stages)]
    outs = []
    for xl in x.split(B // shards):
        if xl.shape[0] % num_micro or xl.shape[0] < num_micro:
            raise ValueError(f"local batch {xl.shape[0]} not divisible into "
                             f"{num_micro} microbatches")
        micro = xl.split(xl.shape[0] // num_micro)
        done = [None] * num_micro
        buf = [None] * n_stages          # each stage's input for this tick
        for t in range(num_micro + n_stages - 1):
            ys = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if 0 <= m < num_micro:
                    ys[s] = stage_fn(params[s], micro[m] if s == 0
                                     else buf[s], s)
            if ys[-1] is not None:
                done[t - n_stages + 1] = ys[-1]
            buf = [None] + ys[:-1]       # shift one stage down the pipe
        outs.append(torch.cat(done))
    return torch.cat(outs)
