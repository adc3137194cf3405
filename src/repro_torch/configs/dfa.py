"""The paper's own DFA system configuration (defaults = Tofino deployment).

PAPER           — faithful Tofino-scale config: 2^17 flows/shard, 10-entry
                  ring, 64 B payload, 20 ms monitoring period, 4096
                  reports/period.
REDUCED         — CPU-testable miniature with the same structure (256
                  flows, 128 reports/period, 128-event blocks, 64-event
                  ingest tiles).
REDUCED_OVERLAP — REDUCED with the software-pipelined streaming driver.
REDUCED_INFER   — ... and the linear immediate-inference head armed.
REDUCED_V2_WIDE — the port's own test preset: the V2 wire at 512 reports
                  per period from 4096 flows, past V1's 256-value seq, so
                  V1 and V2 give different results at this shape.
REDUCED_MULTIPOD    — REDUCED on the 2-D (pod, shard) mesh: hash homes,
                  2 pods of 2 ports, 128 reporter slots per port, 32 due
                  reports per port (pair with n_shards=4).
REDUCED_MULTIPOD_V2 — the same under the V2 wire, with per-port shapes
                  small enough for hundreds of ports.
"""
import dataclasses

from repro_torch.configs.base import DFAConfig

PAPER = DFAConfig()

REDUCED = DFAConfig(
    flows_per_shard=256,
    history=10,
    monitoring_period_us=20_000,
    logstar_bits=7,
    event_block=128,
    report_capacity=128,
    derived_dim=96,
    event_tile=64,             # multiple event tiles per 128-event block
)

REDUCED_OVERLAP = dataclasses.replace(REDUCED, overlap_periods=True)

REDUCED_INFER = dataclasses.replace(REDUCED, overlap_periods=True,
                                    inference_head="linear",
                                    inference_classes=8)

REDUCED_V2_WIDE = dataclasses.replace(REDUCED, wire_format="v2",
                                      flows_per_shard=4096,
                                      report_capacity=512)

REDUCED_MULTIPOD = dataclasses.replace(
    REDUCED,
    flow_home="hash",
    pods=2,
    ports_per_pod=2,
    reporter_slots=128,
    flows_per_shard=128,
    port_report_capacity=32,
)

REDUCED_MULTIPOD_V2 = dataclasses.replace(
    REDUCED_MULTIPOD,
    wire_format="v2",
    reporter_slots=8,
    flows_per_shard=2048,
    port_report_capacity=2,
)
