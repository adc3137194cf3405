"""Both traffic mixes run end to end at small copies of their cells on the
CPU, and the result line has the contract's keys."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, run_small

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    result, lines = run_small(cell, trace)
    keys = list(result)
    assert keys[:5] == TOP_KEYS
    assert keys[-1] == "checks"
    assert set(keys) <= set(TOP_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert [ln.split()[1] for ln in lines] == list(result["checks"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        # the card's vectors per second stay silent here (no device trace)
        assert set(result["metrics"]) == {"setup_s"}
        assert result["metrics"]["setup_s"]["value"] > 0


def test_served_metrics_from_the_host(cell):
    """The host-clock per-layer metrics come out of a traced run on the
    CPU too; the device ones stay silent there (no device trace)."""
    result, _ = run_small(cell, trace=True)
    got = set(result["metrics"])
    host = {"staging_us", "period_p95_ms", "dispatch_us",
            "vectors_per_s.served"} if cell.endswith("served") else \
        {"dispatch_us", "vectors_per_s.direct"}
    assert got == host
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_cli_refuses_without_a_card():
    """No CUDA device: exit 2 and no result line on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "dfa-port.served", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_cli_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "dfa-port.served", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
