"""Model registry: family dispatch and the public ``Model`` facade of the
training and serving paths (the port of ``repro.models.registry``),
for all six of the reference's families: the dense, vlm (llava-next:
the dense model after a patch prefix) and moe families through
``models.lm``, the hybrid family through ``models.hybrid``, the ssm
family (rwkv6) through ``models.rwkv_lm`` and the encdec family
(whisper) through ``models.whisper``.

``Model(cfg)`` runs on the CUDA card unless the caller passes
``device="cpu"``; on the card the attention launches the flash_attention
kernel (K6) and, in the training backward, its gradient (K7); on the CPU
their plain versions run. The ssm family has no attention and launches
neither.
``backend="ref"`` forces the plain version on any device; otherwise
``dispatch.resolve_backend`` applies the reference's precedence
(argument > ``REPRO_KERNEL_BACKEND`` > ``cfg.kernel_backend`` > auto;
a model config has no ``kernel_backend``, so the variable decides).

The mesh helpers (:func:`train_batch_axes`, :func:`decode_axes`,
:func:`input_specs`, ``Model.param_specs``) take a
``launch.mesh.EmulatedMesh`` and give the reference's axes and partition
specs; the dry run (``launch.dryrun``) reads them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import on_card_or_cpu
from repro_torch.kernels import dispatch
from repro_torch.models import hybrid as HY
from repro_torch.models import lm as LM
from repro_torch.models import param as PM
from repro_torch.models import rwkv_lm as RW
from repro_torch.models import whisper as WH

Tree = Any
FAMILIES = LM.FAMILIES + ("hybrid", "ssm", "encdec")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.family!r} is not a model family of the reference; the "
            f"port runs all of them: {', '.join(FAMILIES)}")


def train_batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Longest prefix of (pod, data) whose product divides the batch."""
    sizes = mesh.shape
    axes = []
    prod = 1
    for ax in ("pod", "data"):
        if ax in sizes and global_batch % (prod * sizes[ax]) == 0:
            axes.append(ax)
            prod *= sizes[ax]
    return tuple(axes)


def decode_axes(mesh, batch: int, seq: int
                ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(batch_axes, seq_axes) of a sequence-sharded decode cache: the
    mesh axes the batch does not take shard the cached sequence, dropped
    from the left until their product divides it."""
    sizes = mesh.shape
    batch_axes = train_batch_axes(mesh, batch)
    seq_axes = tuple(ax for ax in mesh.axis_names if ax not in batch_axes)
    while seq_axes and seq % math.prod(sizes[a] for a in seq_axes):
        seq_axes = seq_axes[1:]
    return batch_axes, seq_axes


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """``meta`` stand-ins and partition specs for every input of the
    step of ``shape.kind``: the token batch (with the vlm family's
    patches and the encdec family's frames) for train and prefill, one
    token and its position for decode (the cache's specs come from
    ``launch.steps.cache_specs``). Tokens are int64, the port's
    (``data.tokens``); the reference's are int32."""
    B, S = shape.global_batch, shape.seq_len
    ba = train_batch_axes(mesh, B) or None
    act = PM.torch_dtype(cfg.dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return ({"token": meta((B, 1), torch.int64),
                 "pos": meta((B,), torch.int64)},
                {"token": (ba, None), "pos": (ba,)})
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    n_text = S
    if shape.kind == "prefill" and cfg.family == "vlm":
        n_text = S - cfg.vision.num_patches
    batch = {"tokens": meta((B, n_text), torch.int64)}
    specs = {"tokens": (ba, None)}
    if shape.kind == "train":
        batch["targets"] = meta((B, S), torch.int64)
        batch["mask"] = meta((B, S), torch.float32)
        specs["targets"] = specs["mask"] = (ba, None)
    if cfg.family == "vlm":
        batch["patches"] = meta((B, cfg.vision.num_patches, cfg.d_model), act)
        specs["patches"] = (ba, None, None)
    if cfg.family == "encdec":
        batch["frames"] = meta((B, cfg.encdec.num_frames, cfg.d_model), act)
        specs["frames"] = (ba, None, None)
    return batch, specs


def param_descs(cfg: ModelConfig) -> Tree:
    """The parameter descriptors of ``cfg``'s family."""
    check_family(cfg)
    if cfg.family == "hybrid":
        return HY.hybrid_descs(cfg)
    if cfg.family == "ssm":
        return RW.rwkv_lm_descs(cfg)
    if cfg.family == "encdec":
        return WH.whisper_descs(cfg)
    return LM.lm_descs(cfg)


@dataclass
class Model:
    cfg: ModelConfig
    device: Union[str, torch.device] = "cuda"
    backend: Optional[str] = None

    def __post_init__(self):
        self.device = on_card_or_cpu(self.device, "Model")
        self.backend = dispatch.resolve_backend(self.backend)
        check_family(self.cfg)

    # ---- parameters -----------------------------------------------------
    def param_descs(self) -> Tree:
        return param_descs(self.cfg)

    def init(self, seed: Union[int, torch.Generator] = 0) -> Tree:
        """Random parameters on the model's device, from a seed or a
        ``torch.Generator`` on that device."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return PM.materialize(self.param_descs(), gen, self.device)

    def abstract_params(self) -> Tree:
        """``meta`` tensors of every parameter's shape and dtype."""
        return PM.abstract(self.param_descs())

    def param_specs(self, mesh, rules: Optional[PM.LogicalRules] = None
                    ) -> Tree:
        """Each parameter's partition spec over ``mesh`` (the reference's
        ``param_shardings``), under ``rules`` or the default rules."""
        return PM.partition_specs(self.param_descs(),
                                  rules or PM.default_rules(mesh))

    # ---- training -------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy, plus the multi-token-prediction
        loss where the config has one (``lm.lm_loss``, which reads the vlm
        family's ``batch["patches"]``,
        ``hybrid.hybrid_loss``, ``rwkv_lm.rwkv_loss``,
        ``whisper.whisper_loss``, which reads ``batch["frames"]``), f32
        0-d."""
        cfg, be = self.cfg, self.backend
        fam = cfg.family
        if fam == "hybrid":
            return HY.hybrid_loss(params, batch, cfg, backend=be)
        if fam == "ssm":
            return RW.rwkv_loss(params, batch, cfg)
        if fam == "encdec":
            return WH.whisper_loss(params, batch, cfg, backend=be)
        return LM.lm_loss(params, batch, cfg, backend=be)

    # ---- serving --------------------------------------------------------
    def cache_descs(self, batch: int, seq: int) -> Tree:
        """The decode cache's descriptors: a list per layer (or hybrid
        segment), or for the ssm family one dict of stacked states."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "hybrid":
            return HY.hybrid_cache_descs(cfg, batch, seq)
        if fam == "ssm":
            return RW.rwkv_cache_descs(cfg, batch, seq)
        if fam == "encdec":
            return WH.whisper_cache_descs(cfg, batch, seq)
        return LM.cache_descs(cfg, batch, seq)

    def prefill(self, params, batch) -> Tuple[torch.Tensor, Tree]:
        cfg, be = self.cfg, self.backend
        fam = cfg.family
        if fam == "hybrid":
            return HY.hybrid_prefill(params, batch, cfg, backend=be)
        if fam == "ssm":
            return RW.rwkv_prefill(params, batch, cfg)
        if fam == "encdec":
            return WH.whisper_prefill(params, batch, cfg, backend=be)
        return LM.lm_prefill(params, batch, cfg, backend=be)

    def decode(self, params, token, pos, cache) -> Tuple[torch.Tensor, Tree]:
        """One decode step; the cache's tensors are updated in place."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "hybrid":
            return HY.hybrid_decode(params, token, pos, cache, cfg)
        if fam == "ssm":
            return RW.rwkv_decode(params, token, pos, cache, cfg)
        if fam == "encdec":
            return WH.whisper_decode(params, token, pos, cache, cfg)
        return LM.lm_decode(params, token, pos, cache, cfg)
