#!/usr/bin/env python3
"""What the fused K7 design's ordered dQ additions cost, on the card.

Builds two modified copies of csrc/flash_attention_bwd.cu beside the
shipped one, under build/k7_parts/ (the shipped source is not touched),
and times ``attn_bwd_fused_wgmma_kernel`` from each at granite-3-2b's,
whisper-tiny's encoder and llava-next-mistral-7b's training shapes:

* ``shipped``: as committed;
* ``unordered``: the reducers do not wait for their turn (no counter
  spin): the bulk adds land in any order, so dq is not deterministic
  (and the first store may land after an add): for timing only;
* ``no_reduce``: the reducers hand the staging tile back without any
  bulk copy or wait: dq is garbage: for timing only.

shipped - unordered is the waits' share, unordered - no_reduce the bulk
adds' (beside the consumers, hidden or not). Each copy is timed through
the shipped wrapper with its library swapped in, in turns (shipped,
unordered, no_reduce, no_reduce, unordered, shipped), by torch.profiler's
device time per call split by kernel (chip_smoke.py's ``device_split``).
Prints one JSON line with the card and its power limit.

    python3 tools/k7_fused_parts.py      # needs nvcc and a CUDA card
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "k7_parts"
WAIT = "        wait_count(count + tile, turn);\n"
REDUCE_FROM = WAIT
REDUCE_TO = "        release_count(count + tile);\n"
HANDBACK = "        mbar_arrive(dq_empty + cw);\n"
# name: (K7's batch x heads, kv heads, tokens, head dim, causal)
SHAPES = {"granite": (128, 32, 1024, 64, True),
          "whisper": (48, 48, 1500, 64, False),
          "llava": (128, 32, 3904, 128, True)}


def variants(text: str) -> dict:
    """The source text of each build."""
    if text.count(WAIT) != 1 or text.count(REDUCE_TO) != 1:
        raise SystemExit("the reducer's lines are not in the source")
    a = text.index(REDUCE_FROM)
    b = text.index(REDUCE_TO) + len(REDUCE_TO)
    return {"shipped": text, "unordered": text.replace(WAIT, ""),
            "no_reduce": text[:a] + HANDBACK + text[b:]}


def build_all(texts: dict) -> dict:
    """One nvcc per copy, all at once: {name: library path}."""
    from repro_torch.kernels import build as B
    procs = {}
    for name, text in texts.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "hopper.cuh").write_text((SRC / "hopper.cuh").read_text())
        (out / "flash_attention_bwd.cu").write_text(text)
        lib = out / "flash_attention_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [B.nvcc(), *B.NVCC_FLAGS, "-o", str(lib),
             str(out / "flash_attention_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k7_fused_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import K7_SPLIT, device_split
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K

    libs = build_all(variants(
        (SRC / "flash_attention_bwd.cu").read_text()))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd
        fn.argtypes, fn.restype = BK.KERNEL.argtypes, ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(fns) + list(reversed(fns))
    rows = {}
    for shape, (BH, BHkv, S, D, causal) in SHAPES.items():
        G = BH // BHkv
        rnd = lambda *s: torch.randn(*s, generator=gen,
                                     device=dev).to(torch.bfloat16)
        q, k, v, do = rnd(BH, S, D), rnd(BHkv, S, D), rnd(BHkv, S, D), \
            rnd(BH, S, D)
        o, lse = K.flash_attention_cuda(q, k, v, group=G, causal=causal,
                                        with_lse=True)
        assert BK.variant(q.dtype, D, D) == "fused"
        call = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                   group=G, causal=causal)
        got = {name: [] for name in fns}
        for name in order:
            BK.KERNEL._fn = fns[name]
            got[name].append(device_split(call, 5, K7_SPLIT["fused"]))
        rows[shape] = {
            name: {fn: sum(s[fn] for s in splits) / len(splits)
                   for fn in K7_SPLIT["fused"]}
            for name, splits in got.items()}
        BK.KERNEL._fn = None
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "device_us": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
