#!/usr/bin/env python3
"""Time the port's attention kernels, K6 (flash_attention) and K7
(flash_attention_bwd), from one source tree, on the card.

    python3 tools/attention_ab.py --src <tree>/src [--tag A]

Each kernel runs the variant the tree's ``kernel.variant`` names, at the
model paths' shapes (bf16, causal, 1024 tokens, B = 4): granite-3-2b's
(32 / 8 heads of 64), zamba2-2.7b's (32 / 32 heads of 80), qwen3-14b's
and llama4-scout's (40 / 8 heads of 128) and deepseek-v3's MLA (128
heads, D = 192, Dv = 128, group 1). It
prints one JSON line: the card and its power limit, the tag and tree,
and per shape the variant and the device µs per call (torch.profiler's
device events in the kernel's own functions, as chip_smoke.py's
``device_us``). The kernels build into the tree's own ``build/``. To
compare two trees, run this for each in turns (A, B, B, A) inside one
call on one card. Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (heads, kv heads, D, Dv)
SHAPES = {"granite": (32, 8, 64, 64), "zamba2": (32, 32, 80, 80),
          "qwen/llama4": (40, 8, 128, 128), "mla": (128, 128, 192, 128)}
B, S = 4, 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import device_us
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (H, KH, D, Dv) in SHAPES.items():
        G = H // KH
        rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                         device=dev).to(torch.bfloat16)
        q, k, v = rnd(B * H, S, D), rnd(B * KH, S, D), rnd(B * KH, S, Dv)
        do = rnd(B * H, S, Dv)
        o, lse = K.flash_attention_cuda(q, k, v, group=G, with_lse=True)
        fwd = lambda: K.flash_attention_cuda(q, k, v, group=G)
        bwd = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                  group=G)
        rows[name] = {"variant": K.variant(q.dtype, D, Dv),
                      "k6_us": device_us(K.KERNEL, fwd, 10),
                      "k7_us": device_us(BK.KERNEL, bwd, 5)}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "tag": args.tag, "src": args.src,
                      "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
