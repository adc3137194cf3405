#!/usr/bin/env python3
"""Time the port's online serving loop from one source tree, on the card.

    python3 tools/serving_ab.py --src <tree>/src [--periods 300] [--tag A]

Builds the PAPER V2 system with chip_smoke.py's seeded mlp head, replays
2^20 events per 20 ms period at line rate through ``ServingLoop`` (no
snapshots) for ``--periods`` periods after a 5-period warm-up, and
prints one JSON line: the card and its power limit, the tag and tree,
p50 / p99 / p999 and violations against 20,000 us, and the host's time
per period by part (mean, µs). The kernels build into the tree's own
``build/``. To compare two trees, run this for each in turns (A, B, B,
A) inside one call on one card, since cards and hosts differ between
calls. Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

EVENTS = 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--periods", type=int, default=300)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import PAPER
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK
    from repro_torch.launch.serving import ServingLoop, build_source

    cfg = dataclasses.replace(PAPER, wire_format="v2", inference_head="mlp",
                              serve_offered_eps=EVENTS / 0.02,
                              serve_budget_us=20_000)
    rng = np.random.default_rng(0)          # chip_smoke.paper_dfa's head
    D, Hd, C = cfg.derived_dim, cfg.inference_hidden, cfg.inference_classes
    params = {"w1": 0.1 * rng.standard_normal((D, Hd), np.float32),
              "b1": np.zeros(Hd, np.float32),
              "w2": 0.1 * rng.standard_normal((Hd, C), np.float32),
              "b2": np.zeros(C, np.float32)}
    system = DFASystem(cfg, device="cuda", infer_params=params)
    events, nows = PK.period_batches(
        1, 9, EVENTS, n_flows=cfg.flows_per_shard, flow_seed=0,
        period_us=20_000, window_us=20_000, device="cuda")
    host = {k: v.cpu() for k, v in events.items()}

    def loop():
        return ServingLoop(system, build_source(system, host, nows,
                                                batch_events=EVENTS))

    loop().run(5)
    torch.cuda.synchronize()
    rep = loop().run(args.periods)
    ok = rep.balanced and rep.dropped == 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "tag": args.tag, "src": args.src, "card": smi,
        "periods": args.periods, "balanced": ok,
        **{k: rep.latency[k] for k in ("p50", "p99", "p999")},
        "violations": rep.violations,
        "host_us": {k: float(np.mean(v)) for k, v in rep.host_us.items()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
