#!/usr/bin/env python3
"""Time source variants of K6's ping-pong kernel against each other, in
turns, inside one process on the card.

    python3 tools/k6_variants.py '{"shipped": [], "other": [["a", "b"]]}' \\
        [granite,qwen,whisper,llava]

The first argument is JSON: variant name -> a list of text substitutions
[old, new] applied to src/repro_torch/csrc/flash_attention.cu (each old
text must occur in it), or the path of a whole source file. Each variant
is built under build/k6_variants/<name>/ (its ptxas registers and spills
printed) and loaded beside the others. At the model shapes (granite-3-2b
B = 4 x 32 / 8 heads of 64, causal, 1024 tokens; qwen3-14b 4 x 40 / 8
heads of 128; whisper-tiny's encoder 4 x 6 heads of 64, 1500 frames, no
mask; llava-next-mistral-7b 4 x 32 / 8 heads of 128, causal, 3904
positions; bf16) every variant runs with the shipped plan and, where that
plan cuts items, with the whole-item plan, then the forced one-schedule
wgmma kernel, in the order A B .. B A; each run's device µs per call
(chip_smoke.device_us) and max |o - o_wgmma| are printed as one JSON line
per shape, then one line with all of them, the card and its power limit.
Exits 1 without a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# name: (query heads, kv heads, tokens, head dim, causal)
SHAPES = {"granite": (128, 32, 1024, 64, True),
          "qwen": (160, 32, 1024, 128, True),
          "whisper": (24, 24, 1500, 64, False),
          "llava": (128, 32, 3904, 128, True)}


def build_variant(name: str, subs) -> ctypes._CFuncPtr:
    """Build variant ``name`` of the source and return its C entry."""
    from chip_smoke import ptxas_lines
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as K
    root = ROOT / "build" / "k6_variants" / name
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(B.CSRC, csrc)
    if isinstance(subs, str):
        src = Path(subs).read_text()
    else:
        src = (csrc / "flash_attention.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            src = src.replace(old, new)
    (csrc / "flash_attention.cu").write_text(src)
    shipped, B.CSRC = B.CSRC, csrc
    try:
        path, report = B.build(["flash_attention"], root / "lib")[
            "flash_attention"]
    finally:
        B.CSRC = shipped
    for fn, line in ptxas_lines(report):
        if re.search(r"pingpong_kernelILi(64|128)E", fn):
            print(f"{name} ptxas {fn[-40:]}: {line}", flush=True)
    entry = getattr(ctypes.CDLL(str(path)), "flash_attention")
    entry.argtypes = K.KERNEL.argtypes
    entry.restype = ctypes.c_int
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_us
    from repro_torch.kernels.flash_attention import kernel as K
    variants = json.loads(sys.argv[1])
    shapes = sys.argv[2].split(",") if len(sys.argv) > 2 else list(SHAPES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    entries = {n: build_variant(n, subs) for n, subs in variants.items()}
    shipped = K.KERNEL.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    slack = K.SPLIT_SLACK
    rows = {}
    for shape in shapes:
        BH, BHkv, S, D, causal = SHAPES[shape]
        rnd = lambda *s: torch.randn(*s, generator=gen,
                                     device=dev).to(torch.bfloat16)
        q, k, v = rnd(BH, S, D), rnd(BHkv, S, D), rnd(BHkv, S, D)
        call = lambda force=None: K.flash_attention_cuda(
            q, k, v, group=BH // BHkv, causal=causal, force_variant=force)
        K.KERNEL._fn = shipped
        want = call("wgmma")
        plans = ["cut", "whole"] if K.plan(BH, S, S, causal,
                                           sms).n_counters else ["cut"]
        runs = [(n, p) for p in plans for n in entries] + [("wgmma", "")]
        times = {}
        for name, how in runs + runs[::-1]:
            K.KERNEL._fn = shipped if name == "wgmma" else entries[name]
            K.SPLIT_SLACK = 1e9 if how == "whole" else slack
            K.plan.cache_clear()
            K._device_plan.cache_clear()
            fn = (lambda: call("wgmma")) if name == "wgmma" else call
            err = float((fn().float() - want.float()).abs().max())
            key = f"{name}/{how}" if how else name
            times.setdefault(key, {"us": [], "max_abs_diff_to_wgmma": err})
            times[key]["us"].append(device_us(K.KERNEL, fn, 10))
        K.SPLIT_SLACK = slack
        K.plan.cache_clear()
        K._device_plan.cache_clear()
        K.KERNEL._fn = shipped
        rows[shape] = times
        print(json.dumps({"shape": shape, **times}), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
