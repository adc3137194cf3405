#!/usr/bin/env python3
"""Run chip_smoke.py's hybrid-family phases alone on the card: K6 and K7
at zamba2-2.7b's attention shape, ``[serve zamba2-2.7b]``, ``[train
zamba2-2.7b]`` and ``[train check]``'s zamba2 cut (12 layers, bf16 and
f32), each with chip_smoke's checks, printing the card and its power
limit, each phase's lines and its wall seconds.

    python3 tools/hybrid_phases.py            # from the repository root

The quick rerun of the hybrid slice on the card (the whole script takes
minutes more). Stops at the first failed check; exits 1 without a CUDA
card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hybrid_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; {smi}",
          flush=True)
    build.build(["flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda", 0)
    phases = (
        ("kernel", lambda: CS.check_flash_attention_zamba2(dev)),
        ("serve", lambda: CS.serve_zamba2_phase(dev)),
        ("train", lambda: CS.train_zamba2_phase(dev)),
        ("train check", lambda: CS.zamba2_step_checks(dev)))
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        print(f"[hybrid phases] {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
