#!/usr/bin/env python3
"""Run chip_smoke.py's ``[tune]`` and ``[dryrun]`` phases alone on the
card, and time training phases with and without the dry run's host
process beside them.

    python3 tools/dryrun_phases.py                  # all three below
    python3 tools/dryrun_phases.py slice            # from the repository root
    python3 tools/dryrun_phases.py tune ab

slice: ``[tune]`` on the main path's traffic, then the dry run's host
process (``chip_smoke.DryrunJob``) beside ``[train]`` and ``[train
llava-next-mistral-7b]``, then ``[dryrun]`` against their measured steps;
tune: ``[tune]`` twice more (K1's tile timings' spread); ab:
granite-3-2b's and zamba2-2.7b's ``[train]`` six times each, in the order
without, with, with, without, without, with a host process beside them
that runs the dry run's longest cell (deepseek-v3 whole on one card),
each step's ms and the mean printed. Every phase keeps chip_smoke's
checks and its ``[clocks]`` lines. Exits 1 without a CUDA card.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AB_ORDER = ("without", "with", "with", "without", "without", "with")
# the dry run's longest cell, in a process that sees no card
BESIDE = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; "
          "from repro_torch.configs import get_config; "
          "from repro_torch.configs.shapes import ShapeConfig; "
          "from repro_torch.launch import dryrun as D, mesh as MS; "
          "D.run_cell('deepseek-v3-671b', 'one_card', False, "
          "cfg=get_config('deepseek-v3-671b'), "
          "shape=ShapeConfig('one_card', 'train', 1024, 4), "
          "mesh=MS.make_local_mesh(1, device='meta'))")


def slice_phases(CS, dev):
    system, events, nows = CS.paper_system(dev)
    CS.phase("tune", CS.tune_phase, dev, system, events, nows)
    del system, events, nows
    dry = CS.DryrunJob()
    measured = {
        "granite-3-2b": CS.phase("train", CS.train_phase, dev)[3],
        "llava-next-mistral-7b": CS.phase(
            "train llava-next-mistral-7b", CS.train_llava_phase, dev)[3]}
    CS.phase("dryrun", CS.dryrun_phase, dry, measured)


def tune_twice(CS, dev):
    system, events, nows = CS.paper_system(dev)
    for i in range(2):
        CS.phase(f"tune {i + 1}", CS.tune_phase, dev, system, events, nows)


def ab(CS, dev):
    import torch
    code = BESIDE.format(root=str(ROOT), src=str(ROOT / "src"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for name, run in (("granite-3-2b", CS.train_phase),
                      ("zamba2-2.7b", CS.train_zamba2_phase)):
        steps = {"with": [], "without": []}
        for i, beside in enumerate(AB_ORDER):
            child = None
            if beside == "with":
                child = subprocess.Popen([sys.executable, "-c", code],
                                         env=env, cwd=str(ROOT))
                time.sleep(5)          # past its imports, into the trace
            m = CS.phase(f"ab {name} {i + 1} {beside}", run, dev)[3]
            if child is not None:
                CS.require(child.poll() is None, "[ab] the host process "
                           "ended before the phase did")
                child.kill()
                child.wait()
            steps[beside].append(m["step_ms"])
            torch.cuda.empty_cache()
        print(f"[ab] {name} step ms without the host process "
              f"{steps['without']}, with it {steps['with']}", flush=True)


def main(argv=None) -> int:
    import torch
    table = {"slice": slice_phases, "tune": tune_twice, "ab": ab}
    which = list(argv if argv is not None else sys.argv[1:]) or list(table)
    unknown = [w for w in which if w not in table]
    if unknown:
        print(f"dryrun_phases: unknown parts {unknown}; known {list(table)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dryrun_phases: no CUDA device", file=sys.stderr)
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
    build.build(["ingest_segment_sums", "ring_scatter", "gather_enrich",
                 "flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda", 0)
    for w in which:
        t0 = time.perf_counter()
        table[w](CS, dev)
        torch.cuda.empty_cache()
        print(f"[dryrun phases] {w}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
