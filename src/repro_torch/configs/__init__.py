"""Configurations: the DFA system's (``PAPER``, ``REDUCED`` and its
variants) and the model architectures the port runs (``--arch <id>``
resolves here)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (DFAConfig, EncDecConfig,
                                     HybridConfig, MLAConfig, MoEConfig,
                                     ModelConfig, SSMConfig, TrainConfig,
                                     VisionStubConfig)
from repro_torch.configs.dfa import (PAPER, REDUCED, REDUCED_INFER,
                                     REDUCED_MULTIPOD, REDUCED_MULTIPOD_V2,
                                     REDUCED_OVERLAP, REDUCED_V2_WIDE)
from repro_torch.configs.shapes import SHAPES, ShapeConfig, shape_applicable

# arch id -> module name, in the reference's order
_ARCH_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-32b": "qwen15_32b",
    "qwen3-14b": "qwen3_14b",
    "granite-20b": "granite_20b",
    "zamba2-2.7b": "zamba2_2p7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-3b": "rwkv6_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["DFAConfig", "EncDecConfig", "HybridConfig", "MLAConfig", "MoEConfig",
           "ModelConfig", "PAPER", "REDUCED", "REDUCED_INFER",
           "REDUCED_MULTIPOD", "REDUCED_MULTIPOD_V2", "REDUCED_OVERLAP",
           "REDUCED_V2_WIDE", "SHAPES", "SSMConfig", "ShapeConfig",
           "TrainConfig", "VisionStubConfig", "get_config", "get_shape",
           "list_archs", "shape_applicable"]
