#!/usr/bin/env python3
"""Time the port's attention kernels, K6 (flash_attention) and K7
(flash_attention_bwd), from one source tree, on the card.

    python3 tools/attention_ab.py --src <tree>/src [--tag A]

Each kernel runs the variant the tree's rule names, at the model paths'
shapes (bf16): granite-3-2b's (32 / 8 heads of 64), zamba2-2.7b's (32 /
32 heads of 80), qwen3-14b's and llama4-scout's (40 / 8 heads of 128)
and deepseek-v3's MLA (128 heads, D = 192, Dv = 128, group 1), causal
over 1024 tokens, B = 4; whisper-tiny's encoder (6 heads of 64, no mask,
1500 frames; K6 at B = 4, K7 at its training B = 8) and
llava-next-mistral-7b's 3904 positions (32 / 8 heads of 128, causal, B =
4). It prints one JSON line: the card and its power limit, the tag and
tree, and per shape the variants, the device µs per call (torch.profiler's
device events in the kernel's own functions, as chip_smoke.py's
``device_us``), K7's split by kernel (null where the profiler lost
launches in every window), where the tree's rule gives K6 the
ping-pong kernel the forced one-schedule wgmma kernel's µs beside it
(``k6_wgmma_us``), and, where it gives K7 the fused design, the forced
three-kernel design's µs beside it; SDPA's
forward and backward (forward + backward minus forward) at the shapes
where D == Dv, as the yardstick; and ``digest``, a SHA-256 of the bits of
every output it made (K6's rule and forced-wgmma outputs, K7's gradients
by the rule's design and the forced three-kernel one) on inputs drawn
from one seed, so two trees' runs show whether their outputs are the
same bits. The kernels build into the tree's own
``build/``. To compare two trees, run this for each in turns (A, B, B,
A) inside one call on one card. Exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# name: (K6's batch, K7's batch, tokens, heads, kv heads, D, Dv, causal)
SHAPES = {"granite": (4, 4, 1024, 32, 8, 64, 64, True),
          "zamba2": (4, 4, 1024, 32, 32, 80, 80, True),
          "qwen/llama4": (4, 4, 1024, 40, 8, 128, 128, True),
          "mla": (4, 4, 1024, 128, 128, 192, 128, True),
          "whisper": (4, 8, 1500, 6, 6, 64, 64, False),
          "llava": (4, 4, 3904, 32, 8, 128, 128, True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F
    from chip_smoke import K7_SPLIT, device_split, device_us
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K

    # a tree whose K7 has no fused design names K6's variant
    k7_rule = getattr(BK, "variant", K.variant)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (B6, B7, S, H, KH, D, Dv, causal) in SHAPES.items():
        G = H // KH
        rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                         device=dev).to(torch.bfloat16)
        q, k, v = rnd(B7 * H, S, D), rnd(B7 * KH, S, D), rnd(B7 * KH, S, Dv)
        do = rnd(B7 * H, S, Dv)
        o, lse = K.flash_attention_cuda(q, k, v, group=G, causal=causal,
                                        with_lse=True)
        q6, k6, v6 = q[:B6 * H], k[:B6 * KH], v[:B6 * KH]
        fwd = lambda: K.flash_attention_cuda(q6, k6, v6, group=G,
                                             causal=causal)

        def fwd_forced(force):
            return lambda: K.flash_attention_cuda(q6, k6, v6, group=G,
                                                  causal=causal,
                                                  force_variant=force)

        def bwd(force=None):
            return lambda: BK.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, group=G, causal=causal,
                force_variant=force)
        v7 = k7_rule(q.dtype, D, Dv)
        outs = [fwd(), bwd()()]
        if K.variant(q.dtype, D, Dv) == "pingpong":
            outs.append(fwd_forced("wgmma")())
        if v7 == "fused":
            outs.append(bwd("wgmma")())
        row = {"variant": K.variant(q.dtype, D, Dv), "k7_variant": v7,
               "digest": digest(outs),
               "k6_us": device_us(K.KERNEL, fwd, 10),
               "k7_us": device_us(BK.KERNEL, bwd(), 5)}
        if row["variant"] == "pingpong":
            row["k6_wgmma_us"] = device_us(K.KERNEL, fwd_forced("wgmma"), 10)
        if v7 in K7_SPLIT:
            row["k7_split"] = split_or_none(device_split, bwd(),
                                            K7_SPLIT[v7])
        if v7 == "fused":
            row["k7_wgmma_us"] = device_us(BK.KERNEL, bwd("wgmma"), 5)
            row["k7_wgmma_split"] = split_or_none(device_split, bwd("wgmma"),
                                                  K7_SPLIT["wgmma"])
        if D == Dv:
            row.update(sdpa_us(F, (q6, k6, v6), (q, k, v, do), B6, B7, S, H,
                               KH, causal))
        rows[name] = row
        del q, k, v, do, o, lse, q6, k6, v6
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "tag": args.tag, "src": args.src,
                      "shapes": rows}), flush=True)
    return 0


def digest(outs) -> str:
    """SHA-256 of the bits of a list of tensors and tuples of tensors."""
    h = hashlib.sha256()
    for out in outs:
        for t in (out if isinstance(out, tuple) else (out,)):
            h.update(t.contiguous().view(torch.int16).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


def split_or_none(device_split, fn, names):
    """K7's device µs by kernel (chip_smoke.device_split over 5 calls), or
    None where the profiler lost some of the kernels' launches in every
    window it tried (seen in the first processes of a call): the split is
    left out of the row, and the row is kept."""
    try:
        return device_split(fn, 5, names)
    except AssertionError as e:
        print(f"attention_ab: {e}", file=sys.stderr, flush=True)
        return None


def sdpa_us(F, qkv6, qkvdo7, B6, B7, S, H, KH, causal) -> dict:
    """SDPA's device µs per call on the same inputs: its forward at K6's
    batch, and its backward (forward + backward minus forward) at K7's."""
    from chip_smoke import device_us
    kw = dict(is_causal=causal, enable_gqa=H != KH)

    def as4(t, B, n):
        return t.detach().view(B, n, S, t.shape[-1])

    q6, k6, v6 = (as4(t, B6, n) for t, n in zip(qkv6, (H, KH, KH)))
    leaves = [as4(t, B7, n).clone().requires_grad_()
              for t, n in zip(qkvdo7[:3], (H, KH, KH))]
    grad_out = as4(qkvdo7[3], B7, H)

    def fwd6():
        with torch.no_grad():
            F.scaled_dot_product_attention(q6, k6, v6, **kw)

    def fwd7():
        with torch.no_grad():
            F.scaled_dot_product_attention(*leaves, **kw)

    def fwd_bwd7():
        out = F.scaled_dot_product_attention(*leaves, **kw)
        torch.autograd.grad(out, leaves, grad_out)
    for _ in range(3):                  # its first calls set up
        fwd_bwd7()
    return {"sdpa_fwd_us": device_us(None, fwd6, 10),
            "sdpa_bwd_us": device_us(None, fwd_bwd7, 5)
            - device_us(None, fwd7, 5)}


if __name__ == "__main__":
    sys.exit(main())
