"""Where the port's entry points put their tensors.

Every entry point runs on the CUDA card unless the caller asks for the
CPU; without a card it raises, naming ``device='cpu'``, instead of
moving the work to the CPU behind the caller's back.
"""
from __future__ import annotations

import torch


def on_card_or_cpu(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a host without
    one raises, naming ``who`` and the ``device='cpu'`` way out."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the CUDA card by default and this host has "
            "none; pass device='cpu' to run the plain PyTorch versions of "
            "the kernels")
    return device
