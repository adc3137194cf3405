"""Assigned input shapes (the port's copy of ``repro.configs.shapes``).
Each LM-family architecture is exercised on all four shapes (the decode
and long shapes serve, they do not train)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Architectures whose every attention path is quadratic cannot run the 500k
# decode cell (no sub-quadratic path exists in the architecture).
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def shape_applicable(family: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return family in SUBQUADRATIC_FAMILIES
    return True
