"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
Every run profiles a few periods after the measured window (the card's
own time); with ``--trace 1`` the benchmark's spans are on there too.
The last line of standard output is the result; the last lines of
standard error are the numbers compared with the reference, each beside
its limit. Without a CUDA card, or where the cell cannot run, it prints
no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every kernel cache at a fixed path inside the checkout (the port's own
# nvcc builds go to build/repro_torch_kernels/ already)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program under test (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T_START)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
