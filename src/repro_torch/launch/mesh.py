"""Mesh construction, emulated on one device (the port of
``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh`` objects over the devices it
finds. The port runs every emulated device on one torch device, so a
mesh here is an :class:`EmulatedMesh`: the reference's axis names and
shape, and that one device. The emulated device count is an argument
(one card emulates any count) where the reference reads
``jax.devices()``; the shapes, axis names and factorisation errors are
the reference's. ``distributed.pipeline.pipeline_apply`` and
``optim.compression.compressed_psum`` take such a mesh; ``DFASystem``
(``n_shards``, ``cfg.pods``) and ``launch.elastic`` keep their own
(pod, shard) layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import torch

from repro_torch.device import on_card_or_cpu


@dataclass(frozen=True)
class EmulatedMesh:
    """A device mesh emulated on ``device``: axis ``axis_names[i]`` has
    ``axis_sizes[i]`` emulated devices, laid out row-major as the
    reference's device array is."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The emulated device count."""
        return math.prod(self.axis_sizes)

    def axis_size(self, names: Union[str, Sequence[str]]) -> int:
        """The product of the sizes of ``names`` (one axis or several)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        return math.prod(self.shape[n] for n in names)


def _mk(shape, axes, device) -> EmulatedMesh:
    return EmulatedMesh(tuple(axes), tuple(int(s) for s in shape),
                        on_card_or_cpu(device, "an emulated mesh"))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> EmulatedMesh:
    """16x16 = 256 chips a pod; multi-pod adds the 2-pod axis (512
    chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_dfa_mesh(pods: int = 1, shards_per_pod: int = 0, *,
                  n_devices: int, device="cuda") -> EmulatedMesh:
    """2D ``(pod, shard)`` mesh of the multi-pod DFA stream over the first
    ``pods * shards_per_pod`` of ``n_devices`` emulated devices.
    ``shards_per_pod`` defaults to spreading all of them; raises with the
    factorisation spelled out when the count does not divide, or is too
    small."""
    if shards_per_pod <= 0:
        if n_devices % pods:
            raise ValueError(
                f"{n_devices} devices do not factor into {pods} pods "
                f"(need a multiple of {pods})")
        shards_per_pod = n_devices // pods
    need = pods * shards_per_pod
    if n_devices < need:
        raise ValueError(
            f"mesh ({pods}, {shards_per_pod}) needs {need} devices, "
            f"have {n_devices}")
    return _mk((pods, shards_per_pod), ("pod", "shard"), device)


def make_local_mesh(n_devices: int = 1, device="cuda") -> EmulatedMesh:
    """Single-host ("data", "model") mesh over ``n_devices`` emulated
    devices: the model axis takes the first of 4, 2, 1 that divides
    them."""
    model = next(m for m in (4, 2, 1) if n_devices % m == 0)
    return _mk((n_devices // model, model), ("data", "model"), device)
