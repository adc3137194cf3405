"""The reference's configuration: the DFA fields a period reads, from a
benchmark configuration file's ``dfa`` object."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RefConfig:
    flows_per_shard: int = 1 << 17
    history: int = 10
    monitoring_period_us: int = 20_000
    logstar_bits: int = 7
    report_capacity: int = 4096
    derived_dim: int = 96
    wire_format: str = "v1"
    flow_home: str = "ingest"
    pods: int = 1
    ports_per_pod: int = 0
    reporter_slots: int = 0
    port_report_capacity: int = 0
    crosspod_exchange: str = "padded"
    inference_head: str = "none"
    inference_classes: int = 8
    inference_hidden: int = 64


def from_fields(fields: dict) -> RefConfig:
    """The reference's view of a configuration's DFA fields; a field that
    changes what a period computes and that the reference does not know
    is refused."""
    known = {f.name for f in dataclasses.fields(RefConfig)}
    # fields that choose how the system runs, not what a period computes
    how = {"event_block", "event_tile", "kernel_backend", "tuning_registry",
           "overlap_periods", "snapshot_every_periods", "snapshot_dir",
           "snapshot_keep", "serve_offered_eps", "serve_budget_us",
           "serve_queue_events", "drop_policy", "rehome_collision_policy"}
    unknown = set(fields) - known - how
    if unknown:
        raise ValueError(f"the reference does not model {sorted(unknown)}")
    cfg = RefConfig(**{k: v for k, v in fields.items() if k in known})
    if cfg.crosspod_exchange != "padded":
        raise ValueError("the reference models the padded pod exchange only")
    return cfg
