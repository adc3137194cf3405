"""The DFA system configuration (the port's own copy).

Field names, defaults and meanings are those of the reference
``DFAConfig`` so a configuration reads the same in both packages. Only
the fields this slice of the port reads (or refuses) are carried; the
mesh, serving, elastic and tuning knobs arrive with the slices that
implement them (ROADMAP §1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class DFAConfig:
    """The paper's own system configuration (Table I / Figs 2, 4).

    Defaults mirror the Tofino deployment: 2^17 flows per pipeline shard,
    10-entry history ring, 64 B RoCEv2 payload (45 B Marina vector + pad),
    20 ms monitoring period target.
    """

    flows_per_shard: int = 1 << 17        # 131,072 — classification table size
    history: int = 10                      # Fig 4 ring depth
    monitoring_period_us: int = 20_000     # 20 ms target interval
    logstar_bits: int = 7                  # mantissa bits kept by the log* LUT
    report_capacity: int = 4096            # max reports routed per step/shard
    derived_dim: int = 96                  # Marina-style derived feature count
    # kernel selection: "auto" | "cuda" | "ref" (repro_torch.kernels
    # .dispatch). "auto" and "cuda" launch the hand-written kernels on
    # CUDA tensors; "ref" forces the plain PyTorch versions on any device
    kernel_backend: str = "auto"
    # wire schema version: "v1" (the paper's layout) | "v2" (u16 fields)
    wire_format: str = "v1"
    # sorted-event tile of the fused ingest (segment sums are cut at tile
    # boundaries); clamped to 256 and to the block's event count
    event_tile: int = 256
    # software-pipelined streaming driver (not in this slice)
    overlap_periods: bool = False
    # immediate-inference head on the enriched features: "none" |
    # "linear" | "mlp" (models.flow_head)
    inference_head: str = "none"
    inference_classes: int = 8         # verdict classes the head emits
    inference_hidden: int = 64         # mlp hidden width (linear ignores)
    # how a flow's home ring is chosen; this slice runs "ingest" only
    flow_home: str = "ingest"
    # transport fault injection (not in this slice; None = off)
    fault_spec: Optional[Any] = None
