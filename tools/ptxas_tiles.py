#!/usr/bin/env python3
"""Registers and spills of K7's (192, 128) dK, dV kernel
(``attn_bwd_dkdv_wgmma_kernel<192, 128>`` in
src/repro_torch/csrc/flash_attention_bwd.cu) at the query-tile heights
``kDkdvBQWide`` may take: the shipped 32 rows and 64. Each height is
built from a copy of the source with nvcc's ptxas report, under
build/ptxas_tiles/.

    python3 tools/ptxas_tiles.py          # needs nvcc (CUDA 12)
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_lines  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "csrc"
SHIPPED = "constexpr int kDkdvBQWide = 32;"


def main() -> int:
    text = (SRC / "flash_attention_bwd.cu").read_text()
    if SHIPPED not in text:
        raise SystemExit(f"{SHIPPED!r} not found in the source")
    for rows in (32, 64):
        out = ROOT / "build" / "ptxas_tiles" / str(rows)
        out.mkdir(parents=True, exist_ok=True)
        (out / "hopper.cuh").write_text((SRC / "hopper.cuh").read_text())
        (out / "flash_attention_bwd.cu").write_text(text.replace(
            SHIPPED, f"constexpr int kDkdvBQWide = {rows};"))
        r = subprocess.run([B.nvcc(), *B.NVCC_FLAGS, "-o",
                            str(out / "k7.so"),
                            str(out / "flash_attention_bwd.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed at {rows} rows:\n{r.stdout}"
                             f"{r.stderr}")
        for fn, line in ptxas_lines(r.stdout + r.stderr):
            if re.search(r"dkdv_wgmma_kernelILi192ELi128E", fn):
                print(f"[ptxas tiles] dK, dV (192, 128), {rows}-row query "
                      f"tiles: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
