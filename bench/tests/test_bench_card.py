"""On the card: one short run of each cell through ``bench/run.py`` comes
out correct, with the contract's device fields."""
import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                        "--seed", "4000000001", "--seconds", "1",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert all(v["value"] <= 105 for k, v in result["metrics"].items()
               if k.endswith("_pct"))
