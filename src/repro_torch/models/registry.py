"""Model registry: family dispatch and the public ``Model`` facade of the
training and serving paths (the port of ``repro.models.registry``:
the dense and moe families through ``models.lm``, the hybrid family
through ``models.hybrid``).

``Model(cfg)`` runs on the CUDA card unless the caller passes
``device="cpu"``; on the card the attention launches the flash_attention
kernel (K6) and, in the training backward, its gradient (K7); on the CPU
their plain versions run.
``backend="ref"`` forces the plain version on any device
(``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import on_card_or_cpu
from repro_torch.kernels import dispatch
from repro_torch.models import hybrid as HY
from repro_torch.models import lm as LM
from repro_torch.models import param as PM

Tree = Any
FAMILIES = LM.FAMILIES + ("hybrid",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP §1 item "
            f"14c); the port runs the {', '.join(FAMILIES)} families")


def param_descs(cfg: ModelConfig) -> Tree:
    """The parameter descriptors of ``cfg``'s family."""
    check_family(cfg)
    if cfg.family == "hybrid":
        return HY.hybrid_descs(cfg)
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
        self._hybrid = self.cfg.family == "hybrid"

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
        loss where the config has one (``lm.lm_loss``,
        ``hybrid.hybrid_loss``), f32 0-d."""
        if self._hybrid:
            return HY.hybrid_loss(params, batch, self.cfg,
                                  backend=self.backend)
        return LM.lm_loss(params, batch, self.cfg, backend=self.backend)

    # ---- serving --------------------------------------------------------
    def cache_descs(self, batch: int, seq: int) -> List[Tree]:
        if self._hybrid:
            return HY.hybrid_cache_descs(self.cfg, batch, seq)
        return LM.cache_descs(self.cfg, batch, seq)

    def prefill(self, params, batch) -> Tuple[torch.Tensor, List[Tree]]:
        if self._hybrid:
            return HY.hybrid_prefill(params, batch, self.cfg,
                                     backend=self.backend)
        return LM.lm_prefill(params, batch, self.cfg, backend=self.backend)

    def decode(self, params, token, pos, cache
               ) -> Tuple[torch.Tensor, List[Tree]]:
        """One decode step; the cache's tensors are updated in place."""
        if self._hybrid:
            return HY.hybrid_decode(params, token, pos, cache, self.cfg)
        return LM.lm_decode(params, token, pos, cache, self.cfg)
