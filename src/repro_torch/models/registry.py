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
``backend="ref"`` forces the plain version on any device
(``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
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
        self.backend = dispatch.check_backend(self.backend)
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
