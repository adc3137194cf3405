"""Shared helpers of the benchmark's tests: the repository root and the
port on the import path, and small copies of the cells that run on the
CPU with the plain versions of the kernels."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("dfa-port.served", "dfa-switch4.direct")
SEED = 2**31 + 12345


def small_spec(cell: str):
    """The cell with the configuration and traffic cut to a size the CPU
    runs in seconds; every other field as the cell has it."""
    from bench import harness
    spec = harness.cell_spec(cell)
    c = spec.config["dfa"]
    c.update(flows_per_shard=256, report_capacity=128, event_block=128,
             event_tile=64)
    if "reporter_slots" in c:
        c.update(reporter_slots=256, port_report_capacity=32)
    spec.mix.update(events_per_port=2048, flows_per_port=300,
                    trace_periods=4, sampled_periods=3, traced_periods=3,
                    traced_passes=1, warm_periods=2)
    return spec


def run_small(cell: str, trace: bool = False, seed: int = SEED,
              seconds: float = 0.3, spec=None):
    """One run of the cell's small copy on the CPU, the look for a card
    skipped: (result line, check lines)."""
    from bench import harness
    return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                       device="cpu", check_chips=False,
                       spec=spec or small_spec(cell))


@pytest.fixture(params=CELLS)
def cell(request):
    return request.param
