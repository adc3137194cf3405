"""LR schedule: linear warmup, then cosine decay to 0.1x (the port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.configs.base import TrainConfig


def lr_at(step, cfg: TrainConfig) -> Union[float, torch.Tensor]:
    """The learning rate at ``step``, computed in f32 as the reference
    does. A tensor step (the optimizer's 0-d counter) gives a 0-d f32
    tensor on its device, with no host sync; an int gives a float."""
    t_step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * torch.clamp(
        t_step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((t_step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    lr = torch.where(t_step < cfg.warmup_steps, warm,
                     cfg.learning_rate * (0.1 + 0.9 * cos))
    return lr if isinstance(step, torch.Tensor) else float(lr)
