"""The paper's own DFA system configuration (defaults = Tofino deployment).

PAPER      — faithful Tofino-scale config: 2^17 flows/shard, 10-entry ring,
             64 B payload, 20 ms monitoring period, 4096 reports/period.
REDUCED    — CPU-testable miniature with the same structure (256 flows,
             128 reports/period, 64-event ingest tiles).
"""
from repro_torch.configs.base import DFAConfig

PAPER = DFAConfig()

REDUCED = DFAConfig(
    flows_per_shard=256,
    history=10,
    monitoring_period_us=20_000,
    logstar_bits=7,
    report_capacity=128,
    derived_dim=96,
    event_tile=64,             # multiple event tiles per 128-event block
)
