"""Inference head for DFA-enriched flow features (immediate inference).

``FlowHead(cfg)`` maps (R, derived_dim) features to (R, classes) logits:
"linear" is one projection, "mlp" one hidden ReLU layer of
``cfg.inference_hidden``. Features are log1p-squashed first (raw moment
sums span ~9 decades). Weights keep the reference's (in, out) layout so
parameters cross over unchanged (``repro_torch.convert``); the products
are plain ``torch.matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import DFAConfig


class FlowHead(nn.Module):
    def __init__(self, cfg: DFAConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, C, Hd = cfg.derived_dim, cfg.inference_classes, cfg.inference_hidden
        self.kind = cfg.inference_head
        if generator is None:
            generator = torch.Generator().manual_seed(seed)

        def normal(*shape):
            w = 0.1 * torch.randn(*shape, generator=generator)
            return nn.Parameter(w.to(device), requires_grad=False)

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device),
                                requires_grad=False)

        if self.kind == "linear":
            self.w, self.b = normal(D, C), zeros(C)
        elif self.kind == "mlp":
            self.w1, self.b1 = normal(D, Hd), zeros(Hd)
            self.w2, self.b2 = normal(Hd, C), zeros(C)
        else:
            raise ValueError(f"unknown inference_head {self.kind!r}; "
                             "expected 'linear' or 'mlp'")

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = torch.log1p(torch.abs(feats.to(torch.float32)))
        if self.kind == "linear":
            return x @ self.w + self.b
        h = torch.relu(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2
