#!/usr/bin/env python3
"""Where one block of K6's ping-pong kernel spends its cycles: a copy of
src/repro_torch/csrc/flash_attention.cu with clock64 stamps at each stage
of a consumer's turn, built under build/k6_trace/, run once at each shape
(after 5 warm-up calls); thread 0 of each consumer of block ``block``
records (cycle, stage) pairs, and the cycles between consecutive stages
are summed by stage pair.

    python3 tools/k6_trace.py granite,llava,whisper [block]

Stages: part (a part begins), q ready (its Q tile landed), kv ready (the
turn's K and V tiles landed), turn (the other consumer's turn ended),
issued (the turn's products issued), S done, softmax, PV done, packed
(P in bf16, o rescaled), epi (the part's last P V done), lse (o's and
l's reductions and the lse stored), stored (the output tile handed to its
TMA store). The stamps cost a few cycles each; compare stages, not the
total with the uninstrumented kernel's. The substitutions below name
lines of the shipped source and fail loudly when it changes. Exits 1
without a CUDA card.
"""
from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

SHAPES = {"granite": (128, 32, 1024, 64, True),
          "qwen": (160, 32, 1024, 128, True),
          "whisper": (24, 24, 1500, 64, False),
          "llava": (128, 32, 3904, 128, True)}
STAGES = {0: "part", 1: "q ready", 2: "kv ready", 3: "turn", 4: "issued",
          5: "S done", 6: "softmax", 7: "PV done", 8: "packed", 9: "epi",
          10: "stored", 11: "lse"}
N = 4096                                # stamps per consumer
SUBS = [
    ("struct Part {\n",
     f"__device__ unsigned long long g_trace[2 * {N}];\n"
     "__device__ int g_trace_block;\n"
     "#define TR(ev) do { if (blockIdx.x == g_trace_block && tid == 0 && "
     f"tr_n < {N}) g_trace[cw * {N} + tr_n++] = (static_cast<unsigned long "
     "long>(clock64()) << 8) | (ev); } while (0)\n"
     "struct Part {\n"),
    ("  Part w = load_part(plan, p_begin), next = w;\n",
     "  Part w = load_part(plan, p_begin), next = w;\n  int tr_n = 0;\n"),
    ("    mbar_wait(full_q + qb, (n / QB) & 1);\n",
     "    TR(0);\n    mbar_wait(full_q + qb, (n / QB) & 1);\n    TR(1);\n"),
    ("    wait_k(0);\n    named_sync(my_turn, kConsumerThreads);\n",
     "    wait_k(0);\n    TR(2);\n    named_sync(my_turn, kConsumerThreads);"
     "\n    TR(3);\n"),
    ("    issue_s(0);\n    named_arrive(other_turn, kConsumerThreads);\n"
     "    wgmma_wait<0>();\n    keep(sc);\n",
     "    issue_s(0);\n    named_arrive(other_turn, kConsumerThreads);\n"
     "    TR(4);\n    wgmma_wait<0>();\n    keep(sc);\n    TR(5);\n"),
    ("    softmax(0);                         // o is 0: nothing to rescale\n"
     "    pack_p(sc, pa);\n",
     "    softmax(0);                         // o is 0: nothing to rescale\n"
     "    TR(6);\n    pack_p(sc, pa);\n    TR(8);\n"),
    ("      wait_v(j - 1);\n      named_sync(my_turn, kConsumerThreads);\n",
     "      wait_v(j - 1);\n      TR(2);\n"
     "      named_sync(my_turn, kConsumerThreads);\n      TR(3);\n"),
    ("      issue_pv(j - 1);\n"
     "      named_arrive(other_turn, kConsumerThreads);\n"
     "      wgmma_wait<1>();",
     "      issue_pv(j - 1);\n"
     "      named_arrive(other_turn, kConsumerThreads);\n      TR(4);\n"
     "      wgmma_wait<1>();"),
    ("      keep(sc);\n      release(empty_k + (it + j) % KS);\n",
     "      keep(sc);\n      TR(5);\n"
     "      release(empty_k + (it + j) % KS);\n"),
    ("      softmax(j);\n      wgmma_wait<0>();\n",
     "      softmax(j);\n      TR(6);\n      wgmma_wait<0>();\n"
     "      TR(7);\n"),
    ("      rescale(o, c0, c1);\n      pack_p(sc, pa);\n",
     "      rescale(o, c0, c1);\n      pack_p(sc, pa);\n"
     "      TR(8);\n"),
    ("    wait_v(nt - 1);\n    named_sync(my_turn, kConsumerThreads);\n",
     "    wait_v(nt - 1);\n    TR(2);\n"
     "    named_sync(my_turn, kConsumerThreads);\n    TR(3);\n"),
    ("    issue_pv(nt - 1);\n    named_arrive(other_turn, kConsumerThreads);\n"
     "    wgmma_wait<0>();\n",
     "    issue_pv(nt - 1);\n    named_arrive(other_turn, kConsumerThreads);\n"
     "    TR(4);\n    wgmma_wait<0>();\n    TR(7);\n"),
    ("    it += nt;\n\n    if (w.nparts > 1) {",
     "    it += nt;\n    TR(9);\n\n    if (w.nparts > 1) {"),
    ("    const float y0 = __frcp_rn(den0), y1 = __frcp_rn(den1);\n",
     "    TR(11);\n    const float y0 = __frcp_rn(den0), "
     "y1 = __frcp_rn(den1);\n"),
    ("      bulk_commit();\n    }\n  }\n  if (tid == 0) bulk_wait();",
     "      bulk_commit();\n    }\n    TR(10);\n  }\n"
     "  if (tid == 0) bulk_wait();"),
]
TAIL = f"""
extern "C" int trace_read(void* dst) {{
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}}
extern "C" int trace_setup(int block) {{
  static unsigned long long zeros[2 * {N}];
  cudaError_t e = cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_trace_block, &block, sizeof(int));
  return static_cast<int>(e);
}}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_trace: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as K
    root = ROOT / "build" / "k6_trace"
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(B.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    for old, new in SUBS:
        if src.count(old) != 1:
            raise SystemExit(f"the source changed: {old!r} is not in it "
                             f"once")
        src = src.replace(old, new)
    (csrc / "flash_attention.cu").write_text(src + TAIL)
    shipped, B.CSRC = B.CSRC, csrc
    try:
        path, _ = B.build(["flash_attention"], root / "lib")[
            "flash_attention"]
    finally:
        B.CSRC = shipped
    lib = ctypes.CDLL(str(path))
    entry = lib.flash_attention
    entry.argtypes = K.KERNEL.argtypes
    entry.restype = ctypes.c_int
    K.KERNEL._fn = entry
    lib.trace_read.argtypes = [ctypes.c_void_p]
    lib.trace_setup.argtypes = [ctypes.c_int]
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in sys.argv[1].split(","):
        BH, BHkv, S, D, causal = SHAPES[shape]
        rnd = lambda *s: torch.randn(*s, generator=gen,
                                     device=dev).to(torch.bfloat16)
        q, k, v = rnd(BH, S, D), rnd(BHkv, S, D), rnd(BHkv, S, D)
        call = lambda: K.flash_attention_cuda(q, k, v, group=BH // BHkv,
                                              causal=causal)
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        if lib.trace_setup(block) != 0:
            raise SystemExit("trace_setup failed")
        call()
        torch.cuda.synchronize()
        buf = np.zeros(2 * N, np.uint64)
        if lib.trace_read(buf.ctypes.data) != 0:
            raise SystemExit("trace_read failed")
        parts = K.plan(BH, S, S, causal, sms).blocks[block]
        print(f"== {shape}, block {block}: {len(parts)} parts, "
              f"{sum(p[3] - p[2] for p in parts)} key tiles", flush=True)
        for cw in range(2):
            rec = buf[cw * N:(cw + 1) * N]
            rec = rec[rec != 0]
            clk = (rec >> np.uint64(8)).astype(np.int64)
            ev = (rec & np.uint64(255)).astype(int)
            span = int(clk[-1] - clk[0])
            acc = {}
            for i in range(len(ev) - 1):
                key = f"{STAGES[ev[i]]} -> {STAGES[ev[i + 1]]}"
                a = acc.setdefault(key, [0, 0])
                a[0] += int(clk[i + 1] - clk[i])
                a[1] += 1
            print(f"consumer {cw}: {len(ev)} stamps over {span} cycles",
                  flush=True)
            for key, (c, n) in sorted(acc.items(), key=lambda x: -x[1][0]):
                print(f"  {key:22s} {c:9d} cycles {100 * c / span:5.1f} %"
                      f"  n={n:5d}  mean {c / n:8.1f}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
