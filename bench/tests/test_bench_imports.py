"""Importing and running the harness loads neither JAX nor the JAX
package (top-level module names compared whole: ``repro_torch`` is not
``repro``), and opens nothing under ``benchmarks/``."""
import json
import subprocess
import sys

from conftest import ROOT

SCRIPT = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [sys.argv[1] + "/bench/tests", sys.argv[1] + "/src",
                sys.argv[1]]
from conftest import CELLS, run_small
for cell in CELLS:
    run_small(cell, trace=True)
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"tops": tops,
                  "benchmarks": [p for p in opened if "/benchmarks/" in p
                                 or p.startswith("benchmarks/")]}))
"""


def test_harness_loads_no_jax_and_reads_no_old_benchmark():
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in got["tops"]
    assert got["benchmarks"] == []
