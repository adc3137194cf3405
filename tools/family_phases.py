#!/usr/bin/env python3
"""Run chip_smoke.py's phases of one or more model families alone on the
card, each with chip_smoke's checks, printing the card and its power
limit, each phase's lines and its wall seconds.

    python3 tools/family_phases.py                  # every family below
    python3 tools/family_phases.py ssm encdec       # from the repository root

hybrid (zamba2-2.7b): K6 and K7 at its attention shape, ``[serve
zamba2-2.7b]``, ``[train zamba2-2.7b]`` and ``[train check]``'s zamba2
cut; ssm (rwkv6-3b): ``[serve rwkv6-3b]`` with its card-vs-CPU checks
and ``[train rwkv6-3b]``; encdec (whisper-tiny): K6 and K7 non-causal at
its encoder shapes, ``[serve whisper-tiny]``, ``[train whisper-tiny]`` and
``[train check]``'s whisper run; vlm (llava-next-mistral-7b): K6 and K7
at its 3904-position shapes, ``[serve llava-next-mistral-7b]``, ``[train
llava-next-mistral-7b]`` and ``[train check]``'s llava cut with the
compression and pipeline checks.

The quick rerun of a family's slice on the card (the whole script takes
minutes more). Stops at the first failed check; exits 1 without a CUDA
card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def phases(CS, dev):
    """{family: [(phase name, call)]}."""
    return {
        "hybrid": [
            ("kernel", lambda: CS.check_flash_attention_zamba2(dev)),
            ("serve", lambda: CS.serve_zamba2_phase(dev)),
            ("train", lambda: CS.train_zamba2_phase(dev)),
            ("train check", lambda: CS.zamba2_step_checks(dev))],
        "ssm": [
            ("serve", lambda: CS.serve_rwkv_phase(dev)),
            ("train", lambda: CS.train_rwkv_phase(dev))],
        "encdec": [
            ("kernel", lambda: CS.check_flash_attention_whisper(dev)),
            ("serve", lambda: CS.serve_whisper_phase(dev)),
            ("train", lambda: CS.train_whisper_phase(dev)),
            ("train check", lambda: CS.whisper_step_checks(dev))],
        "vlm": [
            ("kernel", lambda: CS.check_flash_attention_llava(dev)),
            ("serve", lambda: CS.serve_llava_phase(dev)),
            ("train", lambda: CS.train_llava_phase(dev)),
            ("train check", lambda: CS.llava_step_checks(dev))]}


def main(argv=None) -> int:
    import torch
    families = list(argv if argv is not None else sys.argv[1:]) or [
        "hybrid", "ssm", "encdec", "vlm"]
    if not torch.cuda.is_available():
        print("family_phases: no CUDA device", file=sys.stderr)
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
    table = phases(CS, torch.device("cuda", 0))
    unknown = [f for f in families if f not in table]
    if unknown:
        print(f"family_phases: unknown families {unknown}; known "
              f"{list(table)}", file=sys.stderr)
        return 2
    for family in families:
        for name, run in table[family]:
            t0 = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            print(f"[family phases] {family} {name}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
