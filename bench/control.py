"""The comparison's control: the plain reference put in the program's
place and computed one precision lower (features and logits in
bfloat16, where the configuration states float32), held against the
float32 reference by the same comparison and limits as a run.

    python bench/control.py --workload <cell> --seeds 1,2,3 [--periods 32]

prints one JSON line per seed with the readings and whether the
comparison passed (it has to fail). The benchmark's own runs never run
this; it sets the upper readings of ``limits/<cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec, seed: int, periods: int, device, sampled: int = 16):
    """(readings, passed) of the bfloat16 reference against the float32
    one over the cell's first ``periods`` periods from the seed, the
    same number of sampled periods compared as a run compares."""
    import random

    import torch

    from bench import check, drivers, harness, traffic
    from bench.reference.config import from_fields
    from bench.reference.period import RefSystem
    cfg = from_fields(spec.config["dfa"])
    n = int(spec.config["n_shards"])
    head = harness.make_head(cfg, seed, device)
    low = RefSystem(cfg, n, head=head, device=device, dtype=torch.bfloat16)
    ref = RefSystem(cfg, n, head=head, device=device)
    trace, nows = traffic.make_trace(spec.mix, ref.total_ports, seed, device)
    nows = nows.cpu()
    inputs = drivers.INPUTS[spec.mix["entry"]]
    keep = set(random.Random(seed).sample(range(periods),
                                          min(periods, sampled)))
    cmp = check.Comparison(periods, device, head)
    s_low, s_ref = low.init_state(), ref.init_state()
    with torch.no_grad():
        for k in range(periods):
            ev, now = inputs(spec.mix, k, trace, nows)
            s_low, o_low = low.step(s_low, ev, now)
            s_ref, o_ref = ref.step(s_ref, ev, now)
            cmp.metrics(k, o_low.metrics, o_ref.metrics)
            if k in keep:
                cmp.outputs(k, (o_low.enriched, o_low.flow_ids, o_low.mask,
                                o_low.preds), o_ref, spec.limits)
        cmp.state(s_low, s_ref)
    r = cmp.readings()
    return r, check.verdict(r, spec.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--periods", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch

    from bench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r, passed = readings(spec, seed, args.periods, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r, "passed": passed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
