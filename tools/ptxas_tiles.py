#!/usr/bin/env python3
"""Registers and spills of the attention kernels' tensor-core instances
whose register budgets are tight, from nvcc's ptxas report:

* K7's (192, 128) dK, dV kernel (``attn_bwd_dkdv_wgmma_kernel<192, 128>``
  in src/repro_torch/csrc/flash_attention_bwd.cu) at the query-tile
  heights ``kDkdvBQWide`` may take: the shipped 32 rows and 64, each
  built from a copy of the source;
* the (80, 80) instances (zamba2's head dim) of K6
  (``flash_attention_wgmma_kernel<80, 80>``, csrc/flash_attention.cu) and
  of K7 (its prep, dK, dV and dQ kernels), built from the shipped sources.
  K7's dK, dV and dQ kernels must start at the 168 registers their
  setmaxnreg regrouping (24 / 240 / 240) assumes;
* K6's ping-pong instances at (64, 64) and (128, 128)
  (``flash_attention_pingpong_kernel``), which regroup the same way and
  must start at 168 registers too, with no spills (their consumers hold o,
  one tile's scores and P: 160 registers at D = 128).

Each build goes under build/ptxas_tiles/.

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
# the (80, 80) instances: (source, mangled-name pattern, label)
HEAD_DIM_80 = (
    ("flash_attention.cu", r"wgmma_kernelILi80ELi80E", "K6"),
    ("flash_attention_bwd.cu", r"prep_kernelILi80E", "K7 prep"),
    ("flash_attention_bwd.cu", r"dkdv_wgmma_kernelILi80ELi80E", "K7 dK, dV"),
    ("flash_attention_bwd.cu", r"dq_wgmma_kernelILi80ELi80E", "K7 dQ"))
# K6's ping-pong instances: (pattern, label)
PINGPONG = ((r"pingpong_kernelILi64ELi64E", "K6 pingpong (64, 64)"),
            (r"pingpong_kernelILi128ELi128E", "K6 pingpong (128, 128)"))


def ptxas(out: Path, source: str, text: str) -> str:
    """nvcc's ptxas report of ``text`` built as ``out/source`` beside a
    copy of hopper.cuh."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "hopper.cuh").write_text((SRC / "hopper.cuh").read_text())
    (out / source).write_text(text)
    r = subprocess.run([B.nvcc(), *B.NVCC_FLAGS, "-o",
                        str(out / (Path(source).stem + ".so")),
                        str(out / source)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {out / source}:\n{r.stdout}"
                         f"{r.stderr}")
    return r.stdout + r.stderr


def main() -> int:
    text = (SRC / "flash_attention_bwd.cu").read_text()
    if SHIPPED not in text:
        raise SystemExit(f"{SHIPPED!r} not found in the source")
    for rows in (32, 64):
        report = ptxas(ROOT / "build" / "ptxas_tiles" / str(rows),
                       "flash_attention_bwd.cu", text.replace(
                           SHIPPED, f"constexpr int kDkdvBQWide = {rows};"))
        for fn, line in ptxas_lines(report):
            if re.search(r"dkdv_wgmma_kernelILi192ELi128E", fn):
                print(f"[ptxas tiles] dK, dV (192, 128), {rows}-row query "
                      f"tiles: {line}", flush=True)
    reports = {src: ptxas(ROOT / "build" / "ptxas_tiles" / "shipped", src,
                          (SRC / src).read_text())
               for src in {s for s, _, _ in HEAD_DIM_80}}
    for src, pattern, label in HEAD_DIM_80:
        for fn, line in ptxas_lines(reports[src]):
            if re.search(pattern, fn):
                print(f"[ptxas tiles] {label} (80, 80): {line}", flush=True)
    for pattern, label in PINGPONG:
        for fn, line in ptxas_lines(reports["flash_attention.cu"]):
            if re.search(pattern, fn):
                print(f"[ptxas tiles] {label}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
