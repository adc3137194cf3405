#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing is caught). Each timed phase
from 3 on is bracketed by two ``[clocks]`` lines, the card's SM and memory
clocks, power draw and temperature as ``nvidia-smi`` reads them:

1. device — the card's name, count, power limit; TF32 off;
2. build — the seven CUDA kernels from src/repro_torch/csrc, one nvcc per
   source in parallel, into build/repro_torch_kernels/ (ptxas report:
   registers and spills);
3. per-kernel check at the shapes each path gives it — each kernel
   against its plain PyTorch version on the same inputs on the card
   (integers bit for bit, features within 1e-5 of each row's feature
   scale, attention 2e-2 in bf16 and 2e-5 in f32), timed with CUDA events
   in turns (plain, kernel, kernel, plain) beside its bound, and its
   device time per call from torch.profiler's device events;
   flow_moments also against one ``index_add_`` call, flash_attention
   against one ``scaled_dot_product_attention`` call, each library call
   timed by CUDA events and by its device time; flash_attention's cases
   each run the variant ``kernel.variant`` names (``wgmma`` for bf16 with
   (D, Dv) in {(64, 64), (128, 128), (192, 128)}, ``simt`` otherwise), and
   the SIMT kernel is timed at the serving shape beside the tensor-core
   one; flash_attention past head dim 128: deepseek-v3's MLA prefill shape
   (B = 4 x 128 heads, 1024 tokens, D = 192, Dv = 128, group 1, causal) in
   bf16 on the wgmma kernel and, at 64 heads, in f32 on the SIMT one, two
   ragged bf16 MLA shapes (wgmma), and (80, 80), (160, 64), (256, 256)
   (SIMT), each against its plain version, the MLA shape timed in turns
   with its device time, its bound, the SIMT kernel forced onto the same
   inputs and one scaled_dot_product_attention call (or the reason SDPA
   refuses Dv != D); gather_enrich (on
   random and on distinct flow ids) and derived_features (on the
   gathered history and the whole ring) also give their achieved GB/s
   and the bound's share of their device time; flow_moments is also
   checked with registers at 0xFFFFFFF0, and a log line gives its
   atomics per call as counted from the inputs; ring_scatter also on a
   duplicate-heavy batch over several of its rounds, its device launches
   per call (must be 1) and the device time of an empty kernel of the
   same launch shape (its floor); flash_attention_bwd (K7) at the
   training shape (B = 4 x 32 heads, 1024 tokens, head_dim 64, group 4)
   in bf16 on both variants (``wgmma``, and ``simt`` forced) and in f32
   (``simt``) against its plain version (f32 2e-5 of max |grad|, bf16 no
   further from the f32 plain gradient than plain bf16, x1.5; the wgmma
   kernels twice, bit for bit), with o and lse from K6's lse output,
   itself held against the plain logsumexp (1e-4); the wgmma and the
   SIMT kernels timed in turns and by their device time, SDPA's backward
   (forward + backward minus forward) as the library yardstick, and the
   wgmma kernels' share of the bound and factor against SDPA logged;
   flash_attention_bwd at MLA's training shape (B = 4 x 128 heads, 1024
   tokens, D = 192, Dv = 128, group 1, causal) in f32 (simt) and bf16
   (wgmma, twice bit for bit, and simt forced) under the same rules, the
   wgmma kernels timed in turns with the plain version and with the SIMT
   kernels, by their device time (split by kernel), beside the bound and
   SDPA's backward (or the reason it refuses Dv != D); K6 and K7 at
   zamba2-2.7b's attention shape (B = 4 x 32 heads of 80, MHA, 1024
   tokens, causal) on their SIMT kernels, in bf16 and f32, under the same
   rules, each timed in turns with its plain version and by its device
   time beside its bound and SDPA's (the forward; forward + backward minus
   forward); K6 and K7 without a mask at whisper-tiny's encoder shapes
   (K6: B = 4 x 6 heads over its 1500 frames, head dim 64, group 1; K7: B
   = 8 x 6 heads) on their wgmma kernels in bf16 and SIMT in f32, under
   the same rules and timed the same way; K6 and K7 causal at
   llava-next-mistral-7b's shapes (B = 4 x 32 heads of 128, group 4, over
   2880 patches + 1024 tokens = 3904 positions, ragged last tiles) on their
   wgmma kernels in bf16 and SIMT in f32, the same way, SDPA with
   enable_gqa;
4. main path at the paper's size — DFASystem on the PAPER config
   (2^17 flows, 10-entry ring, 4096 reports/period) with an mlp head,
   2^20 packet events per 20 ms period from a 131,072-flow trace: one
   warm-up and 8 timed periods with every kernel launch counted, then
   the same periods on the plain versions (backend="ref"), which must
   give the same integer state bit for bit and the same features;
4a. [tune] — K1 at E = 2^20 on the main path's sorted stream at event
   tiles 64, 128 and 256, timed by its device time (a window that saw one
   launch per call) beside its bound, all three recorded in a
   ``kernels.tuning.TuningRegistry`` (the fastest kept) saved to
   build/repro_torch_tuning.json; one main-path period with
   ``REPRO_TUNING_REGISTRY`` at that file and one at a registry forcing
   tile 64, each launching K1 once with its tile and equal to the untuned
   period bit for bit (state, features, preds); a registry armed at a
   malformed file raises;
5. unfused path at PAPER — :func:`unfused_step` (multipass ingest
   through flow_moments, staged placement, history gather +
   derived_features) over the main path's first periods: one warm-up
   and 4 timed, launch counts from 0, every period's integer state,
   metrics, features and preds held against the fused main path;
6. [v2] — the main path's traffic under the V2 wire (16-bit seq): kernel
   run == plain run as in 4, every period with no seq anomaly and every
   report received (V1's per-period anomalies logged beside);
7. [overlap] — ``run_periods_overlapped`` == ``run_periods`` bit for bit at
   PAPER V2 (state, features, preds, metrics), both timed in turns;
8. [faults] — PAPER V2 under the reference tests' MIXED fault spec over 5
   periods: Δbad_checksum == flips, Δseq_anomalies == dups + replays,
   Δlost_reports == drops + flips exactly in every period, kernel run ==
   plain run under the same draws; ring_scatter takes 2R rows;
9. [mesh1d] — the 1-D shard mesh: 4 shards at PAPER per-shard shapes
   (V1, flow_home="ingest") on one card, the main path's trace laid out
   4 x 2^20 events per period for 4 periods; launch counts from 0, the
   kernel run == the plain run (state bit for bit, features row-scaled),
   sent == received + bucket drops + misroutes every period; ms and
   launches per period and the device's idle share;
10. [mesh2d] — the 2-D (pod, shard) mesh at PAPER width under V2
   (flow_home="hash", one port per device, 2^17 reporter slots and 4096
   due reports per port, a 4 x 2^17-flow keyspace), 2^20 events per port
   per period from 2^19 flows for 4 periods, all with the kernels: the
   (1,4), (2,2) and (4,1) meshes give the same merged state and
   flow-sorted outputs bit for bit; on (2,2) (launch counts from 0)
   kernels == plain, ragged == padded, rendezvous kernels == plain,
   overlapped == sequential; ms, launches and idle share as in 9;
11. [serving] — ``ServingLoop`` at PAPER V2 with the mlp head: 1000
   periods of 2^20 events offered at line rate (52,428,800 events/s)
   against a 20,000 us budget, launch counts from 0, p50/p99/p999, SLO
   violations, sustained events/s, the host's time per period by part
   (replay assembly, staging, dispatch, wait), per-period seq anomalies
   and losses (V2's seq wraps every 16 periods) — the full series in
   build/serving_periods.json — and a snapshot every 250 periods,
   the newest restored to the card and held bit for bit against the end
   state; then 40 periods with the kernels against 40 with the plain
   versions (metrics and end state equal), 1.5x line rate into a
   2^21-event queue for 50 periods plus the drain (balanced, with drops),
   and a profile of 2 periods with the host -> device copies of the LUTs
   and checksum positions cached and, for comparison, made on every call;
12. [serving mesh] — ``ServingLoop`` on the PAPER V2 (2,2) mesh under
   rendezvous homes over (0, 3, 5, 9) ([mesh2d]'s shapes, one port per
   device): [mesh2d]'s trace replayed at line rate per port (2^20 events
   per port per 20 ms period, batches of 2^22) for 40 periods, launch
   counts from 0; p50/p99/p999 and violations against 20,000 us, the host
   split, the accounting (offered == processed, nothing dropped), a
   2-period profile; 8 periods with the kernels against 8 with the plain
   versions (end state bit for bit, every period by ``compare_outputs``);
13. [elastic] — the same mesh with a snapshot every 4 periods under
   build/: pod 1 declared dead after period 6 (and again after period 8,
   a counted no-op); the loop recovers in place (restore, re-home,
   2 journal periods replayed) and serves to period 12 on the (1,2)
   survivor mesh, launch counts from 0; its final state equals
   ``elastic.recover_from_snapshot`` + the same batches through the
   survivor, and the same run with the plain versions, bit for bit; the
   stall split into restore, re-home and replay, moved and unsplittable
   rows ("warn" policy); then ``join_system`` + ``expand_state`` grow
   the survivor back to (2,2) with node ids (12, 17): 2 periods with the
   kernels == with the plain versions, the expand time, moved and scanned
   rows;
14. goldens — the REDUCED T=4 run reproduces
   tests/goldens/run_periods_t4.json; REDUCED_MULTIPOD and
   REDUCED_MULTIPOD_V2 on a (2,2) mesh, with the kernels, over the port's
   own cross_pod_mix scenario reproduce run_periods_multipod_t4.json and
   run_periods_multipod_v2_t4.json (ring_checksum included);
15. serving at full width — granite-3-2b (40 layers, d 2048, 32/8 heads,
   bf16, seeded random weights): 4 requests of 1024-token prompts, 32
   greedy tokens each, one warm-up request and 3 timed, every prefill
   launching flash_attention once per layer, all on the wgmma variant (the
   f32 runs below on the simt variant); then the plain run, and the
   checks, on the f32 kernel run's tokens: (a) the same model in f32,
   kernel run against plain run, prefill and teacher-forced decode
   logits within 1e-3 of the largest logit; (b) bf16, the kernel run no
   further from the f32 run than the plain run is (x1.5), with the
   kernel-vs-plain gap printed; (c) the decode step at position P against
   a full forward over P + 1 tokens. Before (a)-(c), each layer's q, k, v
   of one bf16 prefill run again through the wgmma and the SIMT kernel:
   max |o_wgmma - o_simt| / max |o_simt| per layer, held to 2e-2;
16. [serve deepseek-v3] — deepseek-v3 cut to 5 layers (3 dense + 2 MoE, all
   256 experts whole, top-8 sigmoid routing with its bias, full
   vocabulary, MTP block left out; bf16, seeded random weights): the
   requests of 15, one warm-up and 2 timed, each prefill launching K6
   once per layer, all wgmma (MLA's D = 192, Dv = 128); parameters,
   max_memory_allocated, prefill ms, decode ms per step, tok/s; the share
   of (token, expert) pairs each MoE layer drops by capacity (from the
   port's ``route``); the bf16 plain run's logit gap to the kernel run;
   then, with those weights freed, 15's checks (a)-(c) on the 3 dense
   layers (MLA + FFN) with fresh seeded weights;
17. [serve qwen3-14b] — qwen3-14b whole (40 layers, 40/8 heads of 128,
   qk-norm, untied 151,936-row vocabulary, bf16) as 16, K6 on its wgmma
   variant; checks (a)-(c) on 8 of its layers;
18. [serve zamba2-2.7b] — zamba2-2.7b whole (54 Mamba2 layers, d 2560, in
   9 segments each closed by one of 2 shared attention + FFN blocks of 32
   heads of 80; untied 32,000-row vocabulary; 2,527,532,960 parameters,
   bf16) as 16, K6 once per segment (9 per prefill) on its SIMT kernel;
   checks (a)-(c) on 12 layers (2 segments, both shared blocks), (c)
   holding the decode step, which carries the Mamba2 and conv states,
   against a forward over P + 1 tokens;
18a. [serve rwkv6-3b] — rwkv6-3b whole (32 attention-free layers, d
   2560, 40 heads of 64; untied 65,536-row vocabulary; 3,094,620,160
   parameters, bf16) as 16: no K6 launch and no plain attention call;
   then on 4 of its layers with fresh seeded weights: (i) the card's f32
   prefill logits and every state leaf against the CPU's run of the same
   parameters (2 x 256 tokens), within 1e-4 of the largest element; (ii)
   the card's bf16 logits no further from the CPU's f32 logits than the
   CPU's bf16 logits are, x1.5; (iii) in f32 on the card, a prefill over
   1025 tokens (chunks of 41) against a prefill over 1024 (chunks of
   128) plus one decode step, logits and state within 1e-3;
18b. [serve whisper-tiny] — whisper-tiny whole (4 encoder + 4 decoder
   layers, d 384, 6 heads of 64, 1500 stub frames, 58,528,512 parameters,
   bf16) as 16 with B = 4 x 416-token prompts and 32 greedy tokens (its
   448-token text context): each prefill launches K6 4 times without a
   mask (the encoder) and 4 times causal, all wgmma; the encoder's time
   alone; checks (a)-(c) on the whole model;
18c. [serve llava-next-mistral-7b] — llava-next-mistral-7b whole (32
   layers, d 4096, 32/8 heads of 128, untied 32,000-row vocabulary;
   7,241,732,096 parameters, bf16) as 16 with 2880 stub patches
   (``add_modality_stub``) before each 1024-token prompt and decoding from
   position 3904 into a 3936-row cache: each prefill launches K6 32 times,
   causal, all wgmma; no plain attention call; checks (a)-(c) on 4 of its
   layers with the same prefix ((c) against a forward over 3905
   positions);
19. [train] — granite-3-2b training at full width (40 layers, bf16,
   remat="full", AdamW with f32 moments, seeded random weights), B = 4 x
   1024 tokens of data/tokens, 1 warm-up and 4 timed steps, launch counts
   from 0: the loss, gnorm and lr per step, step ms, tokens/s, model
   flops over step time as a share of 989 TFLOP/s, max_memory_allocated,
   flash_attention (2 x 40: the forward and its remat) and
   flash_attention_bwd (40, all on its wgmma kernels) launches per step,
   no plain attention call, and a 1-step profile;
20. [train deepseek-v3] — as 19 for deepseek-v3 at full width cut to its
   3 dense layers (MLA + the 18432-wide FFN; one MoE layer alone holds
   11.3e9 expert parameters), MTP left out, full untied vocabulary, bf16
   AdamW moments (its config's), 1 warm-up and 2 timed steps: 6 K6 and 3
   K7 launches per step, all wgmma (D = 192, Dv = 128);
21. [train llama4-scout] — as 20 for llama4-scout cut to 1 of 48 layers
   (16 experts whole, the shared expert, the 202,048-row untied
   vocabulary, f32 moments; C = 320 slots per expert): 2 K6 and 1 K7
   launches per step, all wgmma (D = 128, group 5), and the share of
   pairs capacity drops;
22. [train zamba2-2.7b] — as 20 for zamba2-2.7b whole (remat, f32
   moments): 18 K6 and 9 K7 launches per step, all SIMT (head dim 80);
   the Mamba2 projections, the SSD scan's products,
   the shared blocks once per segment and the unembedding;
22a. [train rwkv6-3b] — as 20 for rwkv6-3b whole (remat, f32 moments):
   no K6 or K7 launch; the model flops count the time and channel mixes'
   projections and LoRAs, the wkv scan's products and the unembedding;
22b. [train whisper-tiny] — as 20 for whisper-tiny whole, B = 8 x 448
   tokens with 1500 stub frames each (remat on the decoder, f32 moments):
   K6 4 times without a mask (the encoder, not rematerialised) and 8
   times causal, K7 4 + 4, all wgmma, per step by mask;
22c. [train llava-next-mistral-7b] — as 20 for llava-next-mistral-7b at
   full width cut to 12 of 32 layers (f32 moments, remat), B = 4 x 1024
   text tokens, each after its 2880 stub patches: 24 K6 and 12 K7
   launches per step, causal, all wgmma; the model flops count all 3904
   positions, the unembedding the text only;
22d. [dryrun] — ``launch.dryrun`` on meta tensors, in a process of its
   own that sees no card, started after 14 and read here: granite-3-2b
   train_4k on 16 x 16, deepseek-v3 decode_32k on 2 x 16 x 16 and
   zamba2-2.7b long_500k on 16 x 16 (the reference's ``[dryrun] ... OK``
   lines, JSON under build/dryrun/, no collective term); then the
   one-card mesh at B = 4 x 1024: granite-3-2b whole and
   llava-next-mistral-7b's 12-layer cut must fit the card's HBM (their
   FLOPs per step, step-time lower bound and predicted peak beside 19's
   and 22c's measured step ms, reckoned model flops and
   max_memory_allocated, with the ratios), llava whole and deepseek-v3
   whole must not;
23. [train check] — one step's loss and gradients at full width of
   granite-3-2b with 4 layers, of deepseek-v3's 3 dense layers and of
   zamba2-2.7b with 12 layers: bf16 with the kernels, bf16 plain, f32
   plain on the same weights and batch; the relative error of every
   gradient leaf against f32, the kernel run's worst no more than 1.5 x
   the plain run's; and deepseek-v3 at REDUCED width (MoE layers, MLA,
   MTP) and the zamba2 cut (remat on), each in f32, kernels against
   plain, every gradient leaf within 1e-4 of its largest element;
   whisper-tiny whole, both ways; llava-next-mistral-7b cut to 4 layers
   in bf16 at B = 2 x (2880 patches + 1024 tokens); on the same cut in
   f32, ``compressed_psum`` over 4 emulated ranks of a ("pod", "data") =
   (2, 2) mesh (each rank one batch's gradients, two rounds, residuals
   carried: every mean within scale / 2 of the exact mean, every residual
   x - q * scale rounded once); and ``pipeline_apply`` on that mesh, 2
   microbatches, 2 of llava's blocks per stage, bf16, B = 8 x 1024
   tokens: equal to the blocks per microbatch bit for bit, to the whole
   batch within 2e-2, 16 K6 launches;
24. [examples] — examples/torch_*.py on the card through their ``run``:
   quickstart, the serving example (accounting balances, with drops), the
   flow classifier (held-out accuracy > 0.85) and LM training (the loss
   falls by more than 0.2).

Prints a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "run_periods_t4.json"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (guide table)
F32_OPS_PER_S = 67e12        # H100 SXM CUDA-core float32 rate (guide table)
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate (datasheet)
T_MAIN = 8                   # timed main-path periods (after one warm-up)
T_UNFUSED = 4                # timed unfused-path periods (after one warm-up)
EVENTS = 1 << 20             # packet events per period on the main path
FEATURE_TOL = 1e-5           # row-scaled feature tolerance
# K3 / K5 design, in their kernel rows (thread-per-flow before it)
REDESIGNED = "warp-cooperative: lanes per entry, then per feature column"
# K4 design, in its row (a thread per (event, register) before it)
K4_DESIGN = ("whole events per warp (4 x 7 lanes), loads issued together, "
             "one 32-bit RED per non-zero delta")
# K2 design, in its row (three launches and an F*H winner scratch before)
K2_DESIGN = ("one launch: cells hashed to blocks, rows in rounds, last "
             "write elected in a shared table")
PRED_TOL = 1e-5              # head outputs, kernel run vs plain run


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls (CUDA events;
    includes the host side of each call when it is the slower side)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, iters: int):
    """Warm both up, then time plain, kernel, kernel, plain."""
    import torch
    for _ in range(3):
        plain()
        kernel()
    torch.cuda.synchronize()
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def dev_us(e) -> float:
    """Device time of a profiler ``key_averages()`` row, in µs."""
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def device_profile(kernel, fn, iters: int = 20):
    """(device µs, device launches) per call of ``fn`` in ``kernel``'s own
    ``__global__`` functions (``kernel.device_fns``), summed from
    torch.profiler's device events over ``iters`` calls — the kernel's
    time without the Python wrapper around it. ``kernel=None`` sums every
    device event (a library call's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = kernel.device_fns if kernel else ("",)
    who = kernel.name if kernel else "a library call"
    # torch.profiler has come back without any device event for a kernel
    # that ran and passed its check (K5, on an H100): profile up to 3
    # times, and fail if none of them saw the kernel's device time
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(n in e.key for n in names)]
        total = sum(dev_us(e) for e in rows)
        if total > 0:
            break
        log(f"[profile] attempt {attempt + 1}: no device events in {who}'s "
            f"functions {names}")
    require(total > 0, f"the profiler saw no device time in {who}'s "
                       f"functions {names}")
    return total / iters, sum(e.count for e in rows) / iters


def device_us(kernel, fn, iters: int = 20) -> float:
    """Device µs per call of ``fn`` in ``kernel``'s functions (see
    :func:`device_profile`)."""
    return device_profile(kernel, fn, iters)[0]


def achieved(n_bytes: float, n_ops: float, dev_us: float) -> dict:
    """Achieved GB/s over the device time per call, and the bound's share
    of that time (1.0 = at the bound)."""
    b_ms, _ = bound(n_bytes, n_ops)
    return {"gbps": n_bytes / (dev_us * 1e-6) / 1e9,
            "bound_share": b_ms * 1e3 / dev_us}


def feature_err(got, ref) -> float:
    """max |got - ref| per row over that row's feature scale."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().amax(-1, keepdim=True).clamp(min=1.0)
    return float(((got - ref).abs() / scale).max()) if got.numel() else 0.0


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 3: each kernel against its plain version -------------------------

def check_ingest(cfg, dev, flows):
    import torch
    from repro_torch.core import reporter as REP
    from repro_torch.data import packets as PK
    from repro_torch.kernels.ingest_update import kernel as K
    from repro_torch.kernels.ingest_update import ops

    ev = PK.events_to_torch(PK.gen_events(flows, 0, 20_000, EVENTS, seed=1),
                            dev)
    st = REP.init_state(cfg, dev)
    slots = REP.hash_slot(ev["five_tuple"], cfg.flows_per_shard)
    s = K.stream_prep(st.last_ts, st.keys, st.active, slots, ev["ts"],
                      ev["size"], ev["five_tuple"], ev["valid"],
                      cfg.event_tile)
    args = (s.s_slot, s.s_ts, s.s_ps, s.base_ts, s.first.to(torch.int32))
    kw = dict(bits=cfg.logstar_bits, tile=s.tile)
    got = ops.segment_sums(*args, **kw)
    want = ops.segment_sums(*args, **kw, backend="ref")
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"ingest_segment_sums differs from its plain "
                      f"version (max abs err {err})")
    ms, plain_ms = in_turns(lambda: ops.segment_sums(*args, **kw,
                                                     backend="ref"),
                            lambda: ops.segment_sums(*args, **kw), 20)
    Ep = s.s_slot.shape[0]
    n_lut = 1 << cfg.logstar_bits
    # 5 stream words read + one (8,) u32 row written per event, 2 LUTs;
    # ops counted from the source: ~30 integer ops per log*/exp* power
    # (4 powers) plus 7 adds per scan step, log2(tile) steps
    n_bytes = Ep * (5 * 4 + 8 * 4) + 2 * n_lut * 4
    n_ops = Ep * (4 * 30 + 7 * max(1, s.tile.bit_length() - 1))
    return {"kernel": K.KERNEL, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "n_bytes": n_bytes, "n_ops": n_ops,
            "device_us": device_us(K.KERNEL,
                                   lambda: ops.segment_sums(*args, **kw)),
            "shape": f"E={EVENTS} (Ep={Ep}, tile={s.tile}), F=2^17",
            "check": "bitwise"}


def make_ring(cfg, dev, gen):
    """A filled PAPER-size ring (``packets.synthetic_ring``) on the card."""
    from repro_torch.data import packets as PK
    mem, valid = PK.synthetic_ring(cfg.flows_per_shard, cfg.history, gen)
    return mem.to(dev), valid.to(dev)


def check_ring_scatter(cfg, dev, gen, mem0, ev0):
    import torch
    from repro_torch.kernels.ring_scatter import kernel as K
    from repro_torch.kernels.ring_scatter import ops

    F, H, R = cfg.flows_per_shard, cfg.history, cfg.report_capacity
    rounds = K.round_rows()             # rows per round of the kernel
    Rm = 4 * rounds + 17                # five rounds
    pays = torch.randint(-(1 << 31), (1 << 31) - 1, (Rm, 16), generator=gen,
                         dtype=torch.int32).to(dev)
    masks = (torch.rand(Rm, generator=gen) < 0.95).to(dev)
    cells = torch.randint(0, 300, (Rm,), generator=gen)
    cases = {
        # the main path's shape: distinct flows (due flows are unique)
        "distinct": (torch.randperm(F, generator=gen)[:R],
                     torch.randint(0, H, (R,), generator=gen)),
        # many rows per (flow, hist) cell: last write must win
        "duplicates": (torch.randint(0, 256, (R,), generator=gen),
                       torch.randint(0, 2, (R,), generator=gen)),
        # 300 cells written in every round: the last write of each lies in
        # a later round than its first; some rows outside the ring
        "multi-round duplicates": ((cells * 37) % F + (cells == 7) * F,
                                   cells % H - 2 * (cells == 11)),
    }
    err = 0
    for flow, hist in cases.values():
        n = flow.shape[0]
        flow, hist = flow.to(dev), hist.to(dev)
        mk, vk = mem0.clone(), ev0.clone()
        mr, vr = mem0.clone(), ev0.clone()
        ops.ring_scatter(mk, vk, pays[:n], flow, hist, masks[:n])
        ops.ring_scatter(mr, vr, pays[:n], flow, hist, masks[:n],
                         backend="ref")
        torch.cuda.synchronize()
        require(torch.equal(mk, mr) and torch.equal(vk, vr),
                "ring_scatter differs from its plain version")
        require(not torch.equal(mk, mem0), "ring_scatter wrote nothing")
        err = max(err, int((mk.long() - mr.long()).abs().max()))
    flow, hist = (t.to(dev) for t in cases["distinct"])
    pays, mask = pays[:R], masks[:R]
    mk, vk = mem0.clone(), ev0.clone()
    ms, plain_ms = in_turns(
        lambda: ops.ring_scatter(mk, vk, pays, flow, hist, mask,
                                 backend="ref"),
        lambda: ops.ring_scatter(mk, vk, pays, flow, hist, mask), 50)
    cells = flow.long() * H + hist.long()
    winners = int(torch.unique(cells[mask]).numel())
    # each row's payload + coords + mask read once; each winning cell's
    # 64 B entry and validity byte written once
    n_bytes = (R * (64 + flow.element_size() + hist.element_size() + 1)
               + winners * (64 + 1))
    dev_us, launches = device_profile(K.KERNEL, lambda: ops.ring_scatter(
        mk, vk, pays, flow, hist, mask))
    require(launches == 1, f"ring_scatter made {launches} device launches "
                           "per call, expected 1")
    floor_us, _ = device_profile(K.FLOOR, lambda: K.launch_floor(R, dev))
    return {"kernel": K.KERNEL, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "n_bytes": n_bytes, "n_ops": 0,
            "device_us": dev_us, "device_launches_per_call": launches,
            "floor_us": floor_us, "redesigned": K2_DESIGN,
            "shape": f"R={R} into ({F}, {H}, 16), distinct cells "
                     f"(duplicate-cell batches of R={R} and R={Rm} over "
                     f"{Rm // rounds + 1} rounds checked too)",
            "check": "bitwise"}


def check_gather_enrich(cfg, dev, gen, mem, valid):
    """K3 at the main path's R from the PAPER ring, row-scaled against its
    plain version, on random ids (duplicates among them; timed) and on
    distinct ids (the main path's shape: due flows are unique)."""
    import torch
    from repro_torch.kernels.gather_enrich import kernel as K
    from repro_torch.kernels.gather_enrich import ops

    F, H, R, D = (cfg.flows_per_shard, cfg.history, cfg.report_capacity,
                  cfg.derived_dim)
    cases = {"random ids": torch.randint(0, F, (R,), generator=gen),
             "distinct ids": torch.randperm(F, generator=gen)[:R]}
    cases = {label: ids.to(dev) for label, ids in cases.items()}
    errs = {}
    for label, lf in cases.items():
        got = ops.gather_enrich(mem, valid, lf, cfg)
        want = ops.gather_enrich(mem, valid, lf, cfg, backend="ref")
        torch.cuda.synchronize()
        scaled = feature_err(got, want)
        require(bool(torch.isfinite(got).all()),
                f"gather_enrich ({label}): non-finite")
        require(scaled <= FEATURE_TOL, f"gather_enrich ({label}) differs "
                                       f"from its plain version: row-scaled "
                                       f"err {scaled:.3e}")
        errs[label] = (scaled, float((got - want).abs().max()))
    lf = cases["random ids"]
    ms, plain_ms = in_turns(
        lambda: ops.gather_enrich(mem, valid, lf, cfg, backend="ref"),
        lambda: ops.gather_enrich(mem, valid, lf, cfg), 50)
    rows = int(torch.unique(lf).numel())
    # each gathered flow's H entries + validity read once, ids read, the
    # (R, D) f32 features written; ~100 flops per entry (18 features,
    # window sums, the two-pass variance) plus ~100 per row
    n_bytes = rows * H * (64 + 1) + R * 4 + R * D * 4
    n_ops = R * (H * 100 + 100)
    dev_us = device_us(K.KERNEL, lambda: ops.gather_enrich(mem, valid, lf,
                                                            cfg))
    distinct = cases["distinct ids"]
    return {"kernel": K.KERNEL, "max_abs_err": errs["random ids"][1],
            "row_scaled_err": errs["random ids"][0], "ms": ms,
            "plain_ms": plain_ms, "n_bytes": n_bytes, "n_ops": n_ops,
            "device_us": dev_us, **achieved(n_bytes, n_ops, dev_us),
            "distinct_device_us": device_us(K.KERNEL, lambda: (
                ops.gather_enrich(mem, valid, distinct, cfg))),
            "distinct_row_scaled_err": errs["distinct ids"][0],
            "redesigned": REDESIGNED,
            "shape": f"R={R} from ({F}, {H}, 16), D={D}, random ids "
                     "(distinct ids checked and timed too)",
            "check": f"row-scaled {FEATURE_TOL:g}"}


def check_flow_moments(cfg, dev, flows, gen):
    """K4 on the deltas of the 2^20-event PAPER trace (the unfused path's
    shape), bit for bit against its plain version and one ``index_add_``
    call; plus a wrap-around case and an all-invalid case."""
    import torch
    from repro_torch import u32 as U
    from repro_torch.core import reporter as REP
    from repro_torch.data import packets as PK
    from repro_torch.kernels.flow_moments import kernel as K
    from repro_torch.kernels.flow_moments import ops

    F = cfg.flows_per_shard
    ev = PK.events_to_torch(PK.gen_events(flows, 0, 20_000, EVENTS, seed=1),
                            dev)
    st = REP.init_state(cfg, dev)
    slots = REP.hash_slot(ev["five_tuple"], F)
    _, valid = REP.admit(st, slots, ev["five_tuple"], ev["valid"])
    iat, first, _ = REP.resolve_iat(slots, ev["ts"], valid, st.last_ts,
                                    st.active)
    deltas = U.narrow(REP.event_deltas(iat, ev["size"], first, valid,
                                       cfg.logstar_bits))
    regs = torch.randint(-(1 << 31), (1 << 31) - 1, (F, 7), generator=gen,
                         dtype=torch.int32).to(dev)
    some = valid & (torch.rand(EVENTS, generator=gen) < 0.9).to(dev)
    n_wrap = 256
    cases = {
        "trace": (regs, slots, deltas, valid),
        "trace, 10% invalid": (regs, slots, deltas, some),
        # registers at 0xFFFFFFF0: most of them wrap past 2^32
        "registers at 0xFFFFFFF0": (torch.full((F, 7), -16,
                                               dtype=torch.int32,
                                               device=dev),
                                    slots, deltas, valid),
        # registers at 0xFFFFFF00 (int32 -256), 256 adds of 0x10 to slot 0
        "wrap-around": (torch.full((F, 7), -256, dtype=torch.int32,
                                   device=dev),
            torch.zeros(n_wrap, dtype=torch.int64, device=dev),
            torch.full((n_wrap, 7), 0x10, dtype=torch.int32, device=dev),
            torch.ones(n_wrap, dtype=torch.bool, device=dev)),
        "all invalid": (regs, slots, deltas, torch.zeros_like(valid)),
    }

    def library(r, s, d, v, buf=None):
        """One index_add_ on an (F+1, 7) int32 buffer; invalid rows go to
        the spare row F."""
        if buf is None:
            buf = torch.cat([r, r.new_zeros(1, 7)])
        idx = torch.where(v, s, torch.full_like(s, F))
        buf.index_add_(0, idx, d)
        return buf

    for name, (r, s, d, v) in cases.items():
        got = ops.flow_moments(r, s, d, v)
        want = ops.flow_moments(r, s, d, v, backend="ref")
        lib = library(r, s, d, v)[:F]
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"flow_moments ({name}) differs "
                                        "from its plain version")
        require(torch.equal(got, lib), f"flow_moments ({name}) differs from "
                                       "index_add_")
        if name == "all invalid":
            require(torch.equal(got, r), "flow_moments changed registers "
                                         "with no valid event")
        if name == "wrap-around":
            # 0xFFFFFF00 + 256 * 0x10 = 2^32 + 0xF00
            require(bool((got[0] == 0xF00).all())
                    and torch.equal(got[1:], r[1:]),
                    "flow_moments did not wrap mod 2^32")
    ms, plain_ms = in_turns(
        lambda: ops.flow_moments(regs, slots, deltas, valid, backend="ref"),
        lambda: ops.flow_moments(regs, slots, deltas, valid), 20)
    # the library call alone, on a prepared buffer and index (it
    # accumulates into the buffer call after call)
    buf = torch.cat([regs, regs.new_zeros(1, 7)])
    idx = torch.where(valid, slots, torch.full_like(slots, F))
    buf.index_add_(0, idx, deltas)
    library_ms = time_ms(lambda: buf.index_add_(0, idx, deltas), 20)
    library_dev = device_us(None, lambda: buf.index_add_(0, idx, deltas))
    n_valid = int(valid.sum())
    # (E, 7) u32 deltas, (E,) int64 slots and (E,) validity bytes read
    # once; the (F, 7) registers read and written once; one add per valid
    # (event, register)
    n_bytes = EVENTS * (7 * 4 + 8 + 1) + 2 * F * 7 * 4
    n_ops = n_valid * 7
    dev_us = device_us(K.KERNEL, lambda: ops.flow_moments(regs, slots,
                                                          deltas, valid))
    return {"kernel": K.KERNEL, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "n_bytes": n_bytes, "n_ops": n_ops,
            "library_ms": library_ms, "library_device_us": library_dev,
            "library_note": "one index_add_ on an (F+1, 7) int32 buffer "
                            "(invalid rows to the spare row), bitwise equal",
            "device_us": dev_us, **achieved(n_bytes, n_ops, dev_us),
            "atomics_counted": moments_atomics(slots, deltas, valid, F),
            "redesigned": K4_DESIGN,
            "shape": f"E={EVENTS} trace deltas into ({F}, 7) "
                     "(10%-invalid, registers at 0xFFFFFFF0, wrap-around "
                     "and all-invalid checked too)",
            "check": "bitwise (plain and index_add_)"}


def moments_atomics(slots, deltas, valid, F) -> int:
    """The 32-bit atomics one flow_moments call issues, counted from its
    inputs (not measured): one per non-zero delta of a valid event with
    its slot in [0, F)."""
    live = valid & (slots >= 0) & (slots < F)
    return int(((deltas != 0) & live[:, None]).sum())


def check_derived_features(cfg, dev, gen, mem, valid):
    """K5 on the history the unfused path gathers (R rows of the PAPER
    ring, the main row) and on the whole ring, row-scaled against its
    plain version."""
    import torch
    from repro_torch.kernels.derived_features import kernel as K
    from repro_torch.kernels.derived_features import ops

    F, H, R, D = (cfg.flows_per_shard, cfg.history, cfg.report_capacity,
                  cfg.derived_dim)
    lf = torch.randint(0, F, (R,), generator=gen).to(dev)
    res = {}
    for label, (e, v, iters) in {"gathered": (mem[lf], valid[lf], 50),
                                 "whole ring": (mem, valid, 10)}.items():
        got = ops.derived_features(e, v, cfg)
        want = ops.derived_features(e, v, cfg, backend="ref")
        torch.cuda.synchronize()
        scaled = feature_err(got, want)
        require(bool(torch.isfinite(got).all()),
                f"derived_features ({label}): non-finite")
        require(scaled <= FEATURE_TOL,
                f"derived_features ({label}) differs from its plain "
                f"version: row-scaled err {scaled:.3e}")
        ms, plain_ms = in_turns(
            lambda: ops.derived_features(e, v, cfg, backend="ref"),
            lambda: ops.derived_features(e, v, cfg), iters)
        N = e.shape[0]
        # entries + validity read once, (N, D) f32 written; ~100 flops per
        # entry plus ~100 per row (as for gather_enrich)
        n_bytes, n_ops = N * H * (64 + 1) + N * D * 4, N * (H * 100 + 100)
        dev_us = device_us(K.KERNEL, lambda: ops.derived_features(e, v, cfg))
        res[label] = {"max_abs_err": float((got - want).abs().max()),
                      "row_scaled_err": scaled, "ms": ms,
                      "plain_ms": plain_ms, "n_bytes": n_bytes,
                      "n_ops": n_ops, "device_us": dev_us,
                      **achieved(n_bytes, n_ops, dev_us),
                      "shape": f"({N}, {H}, 16) -> ({N}, {D})"}
    ring = res["whole ring"]
    b_ms, b_by = bound(ring["n_bytes"], ring["n_ops"])
    return {"kernel": K.KERNEL, **res["gathered"], "redesigned": REDESIGNED,
            "shape": res["gathered"]["shape"] + " (R routed flows "
                     "gathered from the PAPER ring; whole ring checked "
                     "too)",
            "check": f"row-scaled {FEATURE_TOL:g}",
            "whole_ring": {k: ring[k] for k in ("ms", "plain_ms",
                                                "device_us", "gbps",
                                                "bound_share",
                                                "row_scaled_err", "shape")}
            | {"bound_ms": b_ms, "bound_by": b_by}}


ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_flash_kernel.py
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 4, 1024, 32, 1056
A_TOL = 1e-3       # f32 logits, kernel run vs plain run, of max |logit|
# bf16: the kernel run's logits may be no further from the f32 run's than
# the plain bf16 run's are, within this factor (both differ from f32 by
# bf16 rounding everywhere; the two differ only in attention rounding)
B_RATIO = 1.5


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the softmax covers (top-left causal mask)."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(0, Sq - Sk) * Sk


def hold_k6_against_plain(name, q, k, v, group, causal, expect):
    """One K6 call against its plain version on the same inputs: it must
    launch the ``expect`` variant once and nothing else, and agree within
    ATT_TOL (abs + rel). In bf16 the kernel must also be no further from
    the f32 plain run on the same inputs than the bf16 plain run is, within
    B_RATIO (max abs distances). Returns (max abs err vs plain, that
    distance ratio or None in f32)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    before = dict(K.KERNEL.launches_by_variant)
    got = ops.flash_attention(q, k, v, group=group, causal=causal)
    torch.cuda.synchronize()
    delta = {n: K.KERNEL.launches_by_variant[n] - before[n] for n in before}
    require(delta == {n: int(n == expect) for n in delta},
            f"flash_attention ({name}) launched {delta}, expected one "
            f"{expect} launch")
    want = ops.flash_attention(q, k, v, group=group, causal=causal,
                               backend="ref").float()
    diff = (got.float() - want).abs()
    tol = ATT_TOL[str(q.dtype).removeprefix("torch.")]
    err = float(diff.max())
    require(bool(torch.isfinite(got).all())
            and float((diff - tol * want.abs()).max()) <= tol,
            f"flash_attention ({name}) differs from its plain version: max "
            f"abs err {err:.3e}, tolerance {tol:g} abs + rel")
    if q.dtype == torch.float32:
        return err, None
    want32 = ops.flash_attention(q.float(), k.float(), v.float(),
                                 group=group, causal=causal, backend="ref")
    err_k = float((got.float() - want32).abs().max())
    err_p = float((want - want32).abs().max())
    require(err_k <= B_RATIO * err_p,
            f"flash_attention ({name}) is {err_k:.3e} from the f32 plain "
            f"run, more than {B_RATIO:g} x the bf16 plain run's {err_p:.3e}")
    return err, err_k / err_p


def check_flash_attention(dev):
    """K6 at the serving path's shape (B = 4 requests x 32 heads, 1024
    tokens, head_dim 64, 8 kv heads, causal, bf16: the wgmma variant)
    against its plain version, the SIMT variant at the same shape, and one
    scaled_dot_product_attention call as the library yardstick; plus an
    f32 run at the same shape, ragged lengths, Sq != Sk both ways, D = 128,
    groups 1 and 8, Dv != D, D = 16, the non-causal softmax and qwen3-14b's
    prefill shape (D = 128, group 5), each on the variant
    ``kernel.variant`` names (:func:`hold_k6_against_plain`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=dev).manual_seed(6)
    H, KH, D = 32, 8, 64
    BH, G, S = SERVE_B * H, H // KH, SERVE_PROMPT

    def inputs(BH, Sq, Sk, D, Dv, group, dtype):
        return attention_inputs(gen, dev, BH, Sq, Sk, D, Dv, group, dtype)

    R = S - 24                                   # not a tile multiple
    cases = {
        "serve bf16": (BH, S, S, D, D, G, "bfloat16", True),
        "serve f32": (BH, S, S, D, D, G, "float32", True),
        f"ragged S={R} bf16": (BH, R, R, D, D, G, "bfloat16", True),
        "Sq=200 Sk=330 D=64 Dv=128 f32": (24, 200, 330, 64, 128, 3,
                                          "float32", True),
        f"non-causal S={R} bf16": (BH, R, R, D, D, G, "bfloat16", False),
        "Sq=200 Sk=330 D=128 group 3 bf16": (24, 200, 330, 128, 128, 3,
                                             "bfloat16", True),
        "Sq=330 Sk=200 D=128 group 3 bf16": (24, 330, 200, 128, 128, 3,
                                             "bfloat16", True),
        "Sq=1000 Sk=700 group 1 bf16": (32, 1000, 700, D, D, 1, "bfloat16",
                                        True),
        "S=1000 group 8 bf16": (64, 1000, 1000, D, D, 8, "bfloat16", True),
        "non-causal Sq=300 Sk=500 D=128 bf16": (24, 300, 500, 128, 128, 3,
                                                "bfloat16", False),
        "S=300 D=16 bf16": (32, 300, 300, 16, 16, 4, "bfloat16", True),
        # qwen3-14b's prefill: B = 4 x 40 heads of 128, 8 kv heads
        "qwen serve bf16": (SERVE_B * 40, S, S, 128, 128, 5, "bfloat16",
                            True),
        "qwen serve f32": (SERVE_B * 40, S, S, 128, 128, 5, "float32", True),
    }
    errs, ran, ratios = {}, {}, {}
    for name, (bh, sq, sk, d, dv, g, dt, causal) in cases.items():
        dtype = getattr(torch, dt)
        q, k, v = inputs(bh, sq, sk, d, dv, g, dtype)
        ran[name] = K.variant(dtype, d, dv)
        errs[name], ratio = hold_k6_against_plain(name, q, k, v, g, causal,
                                                  ran[name])
        if ratio is not None:
            ratios[name] = ratio
    log(f"[kernel] flash_attention max abs err vs plain (variant): "
        f"{ {k: f'{v:.3e} ({ran[k]})' for k, v in errs.items()} }; bf16 "
        f"distance to the f32 plain run, kernel / plain (held <= "
        f"{B_RATIO:g}): { {k: f'{v:.3f}' for k, v in ratios.items()} }")

    q, k, v = inputs(BH, S, S, D, D, G, torch.bfloat16)
    require(K.variant(q.dtype, D, D) == "wgmma",
            "the serving shape does not reach the wgmma variant")
    call = lambda: ops.flash_attention(q, k, v, group=G)
    simt = lambda: K.flash_attention_cuda(q, k, v, group=G,
                                          force_variant="simt")
    ms, plain_ms = in_turns(
        lambda: ops.flash_attention(q, k, v, group=G, backend="ref"), call,
        20)
    # the library yardstick on the same inputs, in the (B, H, S, D) layout
    q4, k4, v4 = (t.view(SERVE_B, -1, S, D) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                 enable_gqa=True)
    lib_err = float((lib().reshape(BH, S, D).float()
                     - call().float()).abs().max())
    simt_err = float((simt().float() - call().float()).abs().max())
    library_ms = time_ms(lib, 20)
    n_ops = 2 * (D + D) * attention_pairs(S, S, True) * BH
    n_bytes = (q.numel() + k.numel() + v.numel() + BH * S * D) * 2
    return {"kernel": K.KERNEL, "max_abs_err": errs["serve bf16"],
            "ms": ms, "plain_ms": plain_ms, "n_bytes": n_bytes,
            "n_ops": n_ops, "ops_per_s": BF16_OPS_PER_S,
            "library_ms": library_ms,
            "library_device_us": device_us(None, lib),
            "library_note": "one scaled_dot_product_attention(is_causal, "
                            f"enable_gqa) call; max abs diff to K6 "
                            f"{lib_err:.3e}",
            "device_us": device_us(K.KERNEL, call),
            "variant": "wgmma",
            "simt_device_us": device_us(K.KERNEL, simt),
            "simt_ms": time_ms(simt, 5),
            "simt_note": f"the SIMT variant on the same inputs; max abs diff "
                         f"to the wgmma variant {simt_err:.3e}",
            "shape": f"q ({BH}, {S}, {D}), k/v ({BH // G}, {S}, {D}), group "
                     f"{G}, causal, bf16 (f32, ragged, Sq != Sk both ways, "
                     "D = 128, groups 1 and 8, Dv != D, D = 16, "
                     "non-causal and qwen3-14b's (160, 1024, 128) group 5 "
                     "checked too)",
            "check": f"bf16 {ATT_TOL['bfloat16']:g}, f32 "
                     f"{ATT_TOL['float32']:g} (abs + rel); bf16 no further "
                     f"from the f32 plain run than plain bf16, x{B_RATIO:g}; "
                     "every case on the variant kernel.variant names",
            "errs": errs, "variants": ran, "bf16_ratios": ratios}


# K6 at deepseek-v3's MLA prefill: B = 4 x 128 heads, 1024 tokens, D = nope +
# rope = 192, Dv = 128, group 1, causal
MLA_HEADS, MLA_D, MLA_DV = 128, 192, 128


def attention_inputs(gen, dev, BH, Sq, Sk, D, Dv, group, dtype):
    import torch
    return (torch.randn(BH, Sq, D, generator=gen, device=dev).to(dtype),
            torch.randn(BH // group, Sk, D, generator=gen,
                        device=dev).to(dtype),
            torch.randn(BH // group, Sk, Dv, generator=gen,
                        device=dev).to(dtype))


def check_flash_attention_wide(dev):
    """K6 past head dim 128: at MLA's prefill shape in bf16 on the wgmma
    kernel's (192, 128) instance and in f32 at 64 heads on the SIMT one,
    two ragged bf16 MLA shapes (wgmma), and (80, 80), (160, 64) and (256,
    256) (SIMT), each on the variant ``kernel.variant`` names and against
    its plain version (:func:`hold_k6_against_plain`); at the MLA shape
    the kernel and the plain version timed in turns, K6's device time, its
    bound, the SIMT kernel forced onto the same inputs (timed, and held
    against the wgmma kernel within ATT_TOL), and one
    scaled_dot_product_attention call where it takes Dv != D. Returns the
    entry for K6's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=dev).manual_seed(23)
    BH, S = SERVE_B * MLA_HEADS, SERVE_PROMPT
    scale = MLA_D ** -0.5
    require(K.variant(torch.bfloat16, MLA_D, MLA_DV) == "wgmma",
            "MLA's head dims should run K6's wgmma kernel in bf16")
    cases = {
        "mla bf16": (BH, S, S, MLA_D, MLA_DV, 1, "bfloat16", True),
        "mla f32 BH=64": (64, S, S, MLA_D, MLA_DV, 1, "float32", True),
        "mla Sq=1000 Sk=700 group 2 bf16": (32, 1000, 700, MLA_D, MLA_DV,
                                            2, "bfloat16", True),
        "mla non-causal Sq=330 Sk=1000 group 3 bf16": (
            24, 330, 1000, MLA_D, MLA_DV, 3, "bfloat16", False),
        "D=80 group 2 ragged bf16": (32, 1000, 1000, 80, 80, 2, "bfloat16",
                                     True),
        "D=80 f32 Sq=300 Sk=500 non-causal": (16, 300, 500, 80, 80, 2,
                                              "float32", False),
        "D=160 Dv=64 group 3 bf16": (24, 330, 200, 160, 64, 3, "bfloat16",
                                     True),
        "D=160 Dv=64 f32": (24, 200, 330, 160, 64, 3, "float32", True),
        "D=256 bf16": (16, 700, 700, 256, 256, 1, "bfloat16", True),
        "D=256 f32 non-causal": (8, 300, 257, 256, 256, 1, "float32",
                                 False),
    }
    errs, ran, ratios = {}, {}, {}
    for name, (bh, sq, sk, d, dv, g, dt, causal) in cases.items():
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(gen, dev, bh, sq, sk, d, dv, g, dtype)
        ran[name] = K.variant(dtype, d, dv)
        errs[name], ratio = hold_k6_against_plain(name, q, k, v, g, causal,
                                                  ran[name])
        if ratio is not None:
            ratios[name] = ratio
        del q, k, v
    log(f"[kernel] flash_attention past head dim 128, max abs err vs plain "
        f"(variant): { {k: f'{v:.3e} ({ran[k]})' for k, v in errs.items()} }"
        f"; bf16 distance to the f32 plain run, kernel / plain (held <= "
        f"{B_RATIO:g}): { {k: f'{v:.3f}' for k, v in ratios.items()} }")

    q, k, v = attention_inputs(gen, dev, BH, S, S, MLA_D, MLA_DV, 1,
                               torch.bfloat16)
    call = lambda: ops.flash_attention(q, k, v, scale=scale)
    simt = lambda: K.flash_attention_cuda(q, k, v, scale=scale,
                                          force_variant="simt")
    ms, plain_ms = in_turns(
        lambda: ops.flash_attention(q, k, v, scale=scale, backend="ref"),
        call, 5)
    dev_time = device_us(K.KERNEL, call, 5)
    wgmma_ms, simt_ms = in_turns(simt, call, 3)
    simt_us = device_us(K.KERNEL, simt, 3)
    simt_err = float((simt().float() - call().float()).abs().max())
    require(simt_err <= ATT_TOL["bfloat16"],
            f"flash_attention at MLA's shape: the wgmma and the SIMT kernel "
            f"differ by {simt_err:.3e}")
    n_ops = 2 * (MLA_D + MLA_DV) * attention_pairs(S, S, True) * BH
    n_bytes = (q.numel() + k.numel() + v.numel() + BH * S * MLA_DV) * 2
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    q4, k4, v4 = (t.view(SERVE_B, MLA_HEADS, S, -1) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                 scale=scale)
    try:
        out = lib()
    except RuntimeError as e:          # no SDPA backend takes Dv != D
        library_ms = library_us = None
        library_note = f"n/a: scaled_dot_product_attention refused: {e}"
    else:
        lib_err = float((out.reshape(BH, S, MLA_DV).float()
                         - call().float()).abs().max())
        library_ms = time_ms(lib, 5)
        library_us = device_us(None, lib, 5)
        library_note = ("one scaled_dot_product_attention(is_causal, "
                        f"scale) call; max abs diff to K6 {lib_err:.3e}")
        del out
    row = {"shape": f"q ({BH}, {S}, {MLA_D}), k ({BH}, {S}, {MLA_D}), v "
                    f"({BH}, {S}, {MLA_DV}), group 1, causal, bf16",
           "variant": "wgmma", "max_abs_err": errs["mla bf16"], "ms": ms,
           "plain_ms": plain_ms, "device_us": dev_time, "bound_ms": b_ms,
           "bound_by": b_by, "n_bytes": n_bytes, "n_ops": n_ops,
           "bound_share": b_ms * 1e3 / dev_time,
           "library_ms": library_ms, "library_device_us": library_us,
           "library_note": library_note, "simt_ms": simt_ms,
           "simt_device_us": simt_us,
           "simt_note": f"the SIMT kernel on the same inputs, in turns with "
                        f"the wgmma one ({wgmma_ms:.5f} ms); max abs diff "
                        f"to it {simt_err:.3e}",
           "errs": errs, "variants": ran, "bf16_ratios": ratios}
    log(f"[kernel] flash_attention at MLA's prefill shape {row['shape']}: "
        f"wgmma kernel {ms:.5f} ms, device {dev_time:.3f} us, plain "
        f"{plain_ms:.5f} ms, bound {b_ms * 1e3:.3f} us by {b_by} "
        f"({n_bytes / 1e6:.1f} MB, {n_ops:.4g} operations), "
        f"{100 * row['bound_share']:.2f} % of the bound; simt kernel "
        f"{simt_ms:.5f} ms, device {simt_us:.3f} us "
        f"({simt_us / dev_time:.2f}x the wgmma kernel); library "
        f"{'n/a' if library_ms is None else f'{library_ms:.5f} ms, device {library_us:.3f} us, the kernel takes {dev_time / library_us:.2f}x its time'}"
        f" ({library_note})")
    del q, k, v, q4, k4, v4
    return row


# K7 at the training shape: B = 4 x 32 heads, 1024 tokens, head_dim 64,
# 8 kv heads (granite-3-2b's), causal
TRAIN_B, TRAIN_S = 4, 1024
BWD_TOL = 2e-5     # f32 gradients, kernel vs plain, of max |grad|
LSE_TOL = 1e-4     # K6's lse vs the plain logsumexp, absolute (lse ~ 10)


def grad_err(got, want) -> float:
    """max |got - want| over max |want|, the worst of a list of tensors."""
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def hold_k7_against_plain(gen, dev, tag, BH, G, S, D):
    """K7 at one GQA shape (q/o/do (BH, S, D), k/v (BH // G, S, D), causal)
    against its plain version on the same inputs, o and lse from K6 with
    its lse output, which is held against the plain logsumexp within
    LSE_TOL: f32 on the SIMT kernels within BWD_TOL of max |grad|; bf16 on
    the variant ``kernel.variant`` names (the wgmma kernels, which repeat
    bit for bit) and forced onto the SIMT ones, each no further from the
    f32 plain gradient than the bf16 plain gradient is, x B_RATIO. Returns
    (errs, abs_errs, lse_errs, the bf16 (q, k, v, o, lse, do))."""
    import torch
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as REF

    require(K.variant(torch.bfloat16, D, D) == "wgmma",
            f"K7 at {tag}'s shape does not reach the wgmma kernels")
    errs, abs_errs, lse_errs = {}, {}, {}
    runs = (("float32", "simt"), ("bfloat16", "wgmma"), ("bfloat16", "simt"))
    for dt, variant in runs:
        dtype = getattr(torch, dt)
        if variant == "wgmma" or dt == "float32":     # new inputs per dtype
            q = torch.randn(BH, S, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(BH // G, S, D, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(BH // G, S, D, generator=gen,
                            device=dev).to(dtype)
            do = torch.randn(BH, S, D, generator=gen, device=dev).to(dtype)
            o, lse = K.flash_attention_cuda(q, k, v, group=G, with_lse=True)
            _, want_lse = REF.flash_attention_lse_ref(q, k, v, group=G)
            lse_errs[dt] = float((lse - want_lse).abs().max())
            require(lse_errs[dt] <= LSE_TOL,
                    f"flash_attention's lse ({tag}, {dt}) differs from the "
                    f"plain logsumexp by {lse_errs[dt]:.3e}")
            want = REF.flash_attention_bwd_ref(q, k, v, o, want_lse, do,
                                               group=G)
        name = f"{dt} {variant}"
        forced = None if variant == K.variant(dtype, D, D) else variant
        before = dict(BK.KERNEL.launches_by_variant)
        got = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=G,
                                          force_variant=forced)
        require(BK.KERNEL.launches_by_variant
                == {**before, variant: before[variant] + 1},
                f"flash_attention_bwd ({tag}, {name}) did not count one "
                f"{variant} launch")
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(g.float()).all()) for g in got),
                f"flash_attention_bwd ({tag}, {name}) gave non-finite "
                f"gradients")
        err = grad_err(got, want)
        abs_errs[name] = max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(got, want))
        errs[name] = err
        if dt == "float32":
            require(err <= BWD_TOL, f"flash_attention_bwd ({tag}, f32) "
                                    f"differs from its plain version: "
                                    f"{err:.3e} of max |grad| > "
                                    f"{BWD_TOL:g}")
            continue
        f32 = REF.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), want_lse, do.float(),
            group=G)
        err_k, err_p = grad_err(got, f32), grad_err(want, f32)
        log(f"[kernel] flash_attention_bwd at {tag}'s shape, bf16 "
            f"({variant}) vs the f32 plain gradient: kernel {err_k:.3e}, "
            f"plain bf16 {err_p:.3e} (held: kernel <= {B_RATIO:g} x plain); "
            f"kernel vs plain bf16 {err:.3e}")
        require(err_k <= B_RATIO * err_p,
                f"flash_attention_bwd ({tag}, bf16, {variant}) is further "
                f"from the f32 gradient than the plain bf16 gradient is")
        if variant == "wgmma":
            again = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=G)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"flash_attention_bwd ({tag}, wgmma) differs between "
                    f"two runs")
            del again
        del f32
    log(f"[kernel] flash_attention_bwd at {tag}'s shape q/o/do ({BH}, {S}, "
        f"{D}), k/v ({BH // G}, {S}, {D}), group {G}: of max |grad| vs plain "
        f"{ {n: f'{e:.3e}' for n, e in errs.items()} }; K6's lse vs the plain "
        f"logsumexp {lse_errs} (tolerance {LSE_TOL:g} absolute)")
    return errs, abs_errs, lse_errs, (q, k, v, o, lse, do)


def check_flash_attention_bwd(dev):
    """K7 against its plain version (:func:`hold_k7_against_plain`) at the
    two training paths' wgmma shapes: granite-3-2b's (B = 4 x 32 heads of
    64, 8 kv heads, the <64> instance) and llama4-scout's (B = 4 x 40
    heads of 128, 8 kv heads, the <128> instance), 1024 tokens, causal.
    At granite's shape both bf16 variants timed in turns and by their
    device time per call, and SDPA's backward as the library yardstick
    (forward + backward of one scaled_dot_product_attention call minus its
    forward, on the same inputs; never called by the port)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import ref as REF

    gen = torch.Generator(device=dev).manual_seed(7)
    l_errs, l_abs, l_lse, tensors = hold_k7_against_plain(
        gen, dev, "llama4-scout", TRAIN_B * 40, 5, TRAIN_S, 128)
    del tensors
    torch.cuda.empty_cache()
    H, KH, D = 32, 8, 64
    BH, G, S = TRAIN_B * H, H // KH, TRAIN_S
    errs, abs_errs, lse_errs, (q, k, v, o, lse, do) = hold_k7_against_plain(
        gen, dev, "granite-3-2b", BH, G, S, D)

    # q, k, v, o, do, lse of the bf16 case are timed
    call = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=G)
    simt = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=G,
                                               force_variant="simt")
    plain = lambda: REF.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                group=G)
    ms, plain_ms = in_turns(plain, call, 5)
    wgmma_ms, simt_ms = in_turns(simt, call, 5)
    q4, k4, v4, do4 = (t.view(TRAIN_B, -1, S, D) for t in (q, k, v, do))
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, leaves, do4)

    for _ in range(3):                  # its first backward sets up
        sdpa_fwd_bwd()
    torch.cuda.synchronize()
    lib_fwd_ms, lib_ms = time_ms(sdpa_fwd, 10), time_ms(sdpa_fwd_bwd, 10)
    lib_dev = device_us(None, sdpa_fwd_bwd) - device_us(None, sdpa_fwd)
    pairs = attention_pairs(S, S, True) * BH
    n_ops = 2 * (3 * D + 2 * D) * pairs
    # q, o, do read and dq written; k, v read and dk, dv written; lse read
    n_bytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    dev_us_ = device_us(BK.KERNEL, call, 5)
    simt_dev_us = device_us(BK.KERNEL, simt, 5)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[kernel] flash_attention_bwd wgmma at the training shape: "
        f"{dev_us_:.2f} us device ({wgmma_ms * 1e3:.2f} us by events, "
        f"in turns with simt {simt_ms * 1e3:.2f}), simt {simt_dev_us:.2f} "
        f"us device ({simt_dev_us / dev_us_:.2f}x); bound {b_ms * 1e3:.2f} "
        f"us by {b_by}: {100 * b_ms * 1e3 / dev_us_:.1f} % of it; SDPA's "
        f"backward {lib_dev:.2f} us device: the kernels take "
        f"{dev_us_ / lib_dev:.2f}x its time")
    return {"kernel": BK.KERNEL, "max_abs_err": abs_errs["bfloat16 wgmma"],
            "ms": ms, "plain_ms": plain_ms, "n_bytes": n_bytes,
            "n_ops": n_ops, "ops_per_s": BF16_OPS_PER_S,
            "library_ms": lib_ms - lib_fwd_ms,
            "library_device_us": lib_dev,
            "library_note": "scaled_dot_product_attention(is_causal, "
                            "enable_gqa) forward + backward minus its "
                            "forward, on the same inputs",
            "device_us": dev_us_,
            "variant": "wgmma",
            "simt_device_us": simt_dev_us,
            "simt_ms": simt_ms,
            "simt_note": f"the SIMT kernels on the same inputs, in turns "
                         f"with the wgmma ones ({wgmma_ms:.5f} ms); max "
                         f"abs err to the plain version "
                         f"{abs_errs['bfloat16 simt']:.3e}",
            "shape": f"q/o/do ({BH}, {S}, {D}), k/v ({BH // G}, {S}, {D}), "
                     f"group {G}, causal, bf16 (f32 checked too; and "
                     f"llama4-scout's (160, {S}, 128) group 5)",
            "check": f"f32 {BWD_TOL:g} of max |grad|; bf16 (wgmma and simt) "
                     f"no further from the f32 plain gradient than plain "
                     f"bf16, x{B_RATIO:g}; wgmma bit for bit twice; K6 lse "
                     f"{LSE_TOL:g} absolute",
            "errs": errs, "abs_errs": abs_errs, "lse_errs": lse_errs,
            "llama4": {"errs": l_errs, "abs_errs": l_abs,
                       "lse_errs": l_lse}}


def device_split(fn, iters: int, names) -> dict:
    """Device µs per call of ``fn`` in each ``__global__`` function of
    ``names``, each of which ``fn`` launches once (torch.profiler's
    device events over ``iters`` calls). The profiler has kept one of K7's
    three kernels and lost the other two in a window (on an H100), so a
    window counts only when every function ran ``iters`` times in it; up
    to 3 windows, and fail if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, seen = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for n in names:
                if n in e.key:
                    us[n] += dev_us(e) / iters
                    seen[n] += e.count
        if all(c == iters for c in seen.values()):
            return us
        log(f"[profile] attempt {attempt + 1}: device launches {seen} in "
            f"{iters} calls")
    raise AssertionError(f"the profiler did not see each of {names} once "
                         f"per call in any of 3 windows")


def check_flash_attention_bwd_mla(dev):
    """K7 at MLA's training shape: B = 4 x 128 heads, 1024 tokens, D = 192,
    Dv = 128, group 1, causal, MLA's scale, o and lse from K6, whose lse
    is held against the plain logsumexp within LSE_TOL. f32 on the SIMT
    kernels within BWD_TOL of max |grad| of the plain version (from the
    plain lse); bf16 on the wgmma kernels' (192, 128) instance (twice, bit
    for bit) and forced onto the SIMT ones, each no further from the f32
    plain gradient than the bf16 plain gradient is, x B_RATIO. The wgmma
    kernels timed in turns with the plain version and with the SIMT
    kernels, by their device time (summed over their three kernels, from
    one profiler window that saw each once per call), beside the bound and
    SDPA's backward (forward + backward minus forward, or the reason it
    refuses Dv != D). Returns the entry for K7's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as REF

    gen = torch.Generator(device=dev).manual_seed(29)
    BH, S, D, Dv = TRAIN_B * MLA_HEADS, TRAIN_S, MLA_D, MLA_DV
    scale = D ** -0.5
    require(K.variant(torch.bfloat16, D, Dv) == "wgmma"
            and K.variant(torch.float32, D, Dv) == "simt",
            "MLA's head dims should run K7's wgmma kernels in bf16 and its "
            "SIMT kernels in f32")
    errs, abs_errs, lse_errs = {}, {}, {}
    runs = (("float32", "simt"), ("bfloat16", "wgmma"), ("bfloat16", "simt"))
    for dt, variant in runs:
        dtype = getattr(torch, dt)
        if variant == "wgmma" or dt == "float32":     # new inputs per dtype
            q, k, v = attention_inputs(gen, dev, BH, S, S, D, Dv, 1, dtype)
            do = torch.randn(BH, S, Dv, generator=gen, device=dev).to(dtype)
            o, lse = K.flash_attention_cuda(q, k, v, scale=scale,
                                            with_lse=True)
            _, want_lse = REF.flash_attention_lse_ref(q, k, v, scale=scale)
            lse_errs[dt] = float((lse - want_lse).abs().max())
            require(lse_errs[dt] <= LSE_TOL,
                    f"flash_attention's lse (MLA, {dt}) differs from the "
                    f"plain logsumexp by {lse_errs[dt]:.3e}")
            want = REF.flash_attention_bwd_ref(q, k, v, o, want_lse, do,
                                               scale=scale)
        name = f"{dt} {variant}"
        forced = None if variant == K.variant(dtype, D, Dv) else variant
        before = dict(BK.KERNEL.launches_by_variant)
        got = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale=scale,
                                          force_variant=forced)
        require(BK.KERNEL.launches_by_variant
                == {**before, variant: before[variant] + 1},
                f"flash_attention_bwd (MLA, {name}) did not count one "
                f"{variant} launch")
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(g.float()).all()) for g in got),
                f"flash_attention_bwd (MLA, {name}) gave non-finite "
                f"gradients")
        errs[name] = grad_err(got, want)
        abs_errs[name] = max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(got, want))
        if dt == "float32":
            require(errs[name] <= BWD_TOL,
                    f"flash_attention_bwd (MLA, f32) differs from its plain "
                    f"version: {errs[name]:.3e} of max |grad| > {BWD_TOL:g}")
            del q, k, v, do, o, lse, want_lse, want, got
            torch.cuda.empty_cache()
            continue
        f32 = REF.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), want_lse, do.float(),
            scale=scale)
        err_k, err_p = grad_err(got, f32), grad_err(want, f32)
        log(f"[kernel] flash_attention_bwd at MLA's shape, bf16 ({variant}) "
            f"vs the f32 plain gradient: kernel {err_k:.3e}, plain bf16 "
            f"{err_p:.3e} (held: kernel <= {B_RATIO:g} x plain); kernel vs "
            f"plain bf16 {errs[name]:.3e}")
        require(err_k <= B_RATIO * err_p,
                f"flash_attention_bwd (MLA, bf16, {variant}) is further from "
                f"the f32 gradient than the plain bf16 gradient is")
        if variant == "wgmma":
            again = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                scale=scale)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    "flash_attention_bwd (MLA, wgmma) differs between two "
                    "runs")
            del again
        del f32, got
    log(f"[kernel] flash_attention_bwd at MLA's shape: of max |grad| vs "
        f"plain { {n: f'{e:.3e}' for n, e in errs.items()} } (f32 held <= "
        f"{BWD_TOL:g}); K6's lse vs the plain logsumexp {lse_errs} (held <= "
        f"{LSE_TOL:g})")
    del want, want_lse
    torch.cuda.empty_cache()

    # the bf16 inputs are timed
    call = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               scale=scale)
    simt = lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               scale=scale,
                                               force_variant="simt")
    plain = lambda: REF.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                scale=scale)
    ms, plain_ms = in_turns(plain, call, 3)
    split = device_split(call, 5, ("attn_bwd_prep_kernel",
                                   "attn_bwd_dkdv_wgmma_kernel",
                                   "attn_bwd_dq_wgmma_kernel"))
    dev_time = sum(split.values())
    wgmma_ms, simt_ms = in_turns(simt, call, 2)
    simt_us = device_us(BK.KERNEL, simt, 2)
    pairs = attention_pairs(S, S, True) * BH
    n_ops = 2 * (2 * D + 2 * Dv + D) * pairs
    # q, k read and dq, dk written (D wide); v, o, do read and dv written
    # (Dv wide); lse read
    n_bytes = 2 * BH * S * (4 * D + 4 * Dv) + 4 * BH * S
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    q4, k4, v4, do4 = (t.view(TRAIN_B, MLA_HEADS, S, -1)
                       for t in (q, k, v, do))
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  scale=scale)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             scale=scale)
        torch.autograd.grad(out, leaves, do4)

    try:
        for _ in range(3):              # its first backward sets up
            sdpa_fwd_bwd()
        torch.cuda.synchronize()
    except RuntimeError as e:           # no SDPA backend takes Dv != D
        library_ms = library_us = None
        library_note = (f"n/a: scaled_dot_product_attention's backward "
                        f"refused: {e}")
    else:
        library_ms = time_ms(sdpa_fwd_bwd, 5) - time_ms(sdpa_fwd, 5)
        library_us = device_us(None, sdpa_fwd_bwd, 3) - device_us(
            None, sdpa_fwd, 3)
        library_note = ("scaled_dot_product_attention(is_causal, scale) "
                        "forward + backward minus its forward, on the same "
                        "inputs")
    row = {"shape": f"q/dq ({BH}, {S}, {D}), k/dk ({BH}, {S}, {D}), v/o/do "
                    f"({BH}, {S}, {Dv}), group 1, causal, bf16 (f32 "
                    f"checked too)",
           "variant": "wgmma", "max_abs_err": abs_errs["bfloat16 wgmma"],
           "ms": ms, "plain_ms": plain_ms, "device_us": dev_time,
           "device_us_by_kernel": split,
           "bound_ms": b_ms, "bound_by": b_by, "n_bytes": n_bytes,
           "n_ops": n_ops, "bound_share": b_ms * 1e3 / dev_time,
           "library_ms": library_ms, "library_device_us": library_us,
           "library_note": library_note, "simt_ms": simt_ms,
           "simt_device_us": simt_us,
           "simt_note": f"the SIMT kernels on the same inputs, in turns with "
                        f"the wgmma ones ({wgmma_ms:.5f} ms); max abs err to "
                        f"the plain version "
                        f"{abs_errs['bfloat16 simt']:.3e}",
           "errs": errs, "abs_errs": abs_errs, "lse_errs": lse_errs}
    log(f"[kernel] flash_attention_bwd at MLA's training shape "
        f"{row['shape']}: wgmma kernels {ms:.5f} ms, device {dev_time:.3f} "
        f"us ({', '.join(f'{n} {u:.1f}' for n, u in split.items())}), plain "
        f"{plain_ms:.5f} ms, bound {b_ms * 1e3:.3f} us by {b_by} "
        f"({n_bytes / 1e6:.1f} MB, {n_ops:.4g} operations), "
        f"{100 * row['bound_share']:.2f} % of the bound; simt kernels "
        f"{simt_ms:.5f} ms, device {simt_us:.3f} us "
        f"({simt_us / dev_time:.2f}x the wgmma kernels); library "
        f"{'n/a' if library_ms is None else f'{library_ms:.5f} ms, device {library_us:.3f} us, the kernels take {dev_time / library_us:.2f}x its time'}"
        f" ({library_note})")
    del q, k, v, o, lse, do, leaves
    torch.cuda.empty_cache()
    return row


# K6 at zamba2-2.7b's prefill shape and K7 at its training shape: B = 4 x 32
# heads of 80, MHA (group 1), 1024 tokens, causal; 80 runs the SIMT kernels
ZAMBA_HEADS, ZAMBA_D = 32, 80


def check_flash_attention_zamba2(dev):
    """K6 and K7 at zamba2-2.7b's attention shape (q, k, v, o, do (128,
    1024, 80), group 1, causal), bf16 on the SIMT kernels, by
    :func:`check_attention_at`. Returns (K6's entry, K7's entry)."""
    return check_attention_at(dev, "zamba2", SERVE_B * ZAMBA_HEADS,
                              SERVE_B * ZAMBA_HEADS, SERVE_PROMPT, ZAMBA_D,
                              True, "simt", 31)


# K6 at whisper-tiny's encoder prefill shape (B = 4 x 6 heads over its 1500
# frames, head dim 64, group 1, full attention) and K7 at its encoder
# training shape (B = 8 x 6 heads)
WHISPER_HEADS, WHISPER_FRAMES, WHISPER_D = 6, 1500, 64
WHISPER_TRAIN_B = 8


def check_flash_attention_whisper(dev):
    """K6 and K7 non-causal at whisper-tiny's encoder shapes (K6: q, k, v
    (24, 1500, 64); K7: (48, 1500, 64); group 1), bf16 on the wgmma
    kernels, by :func:`check_attention_at`. Returns (K6's entry, K7's
    entry)."""
    return check_attention_at(dev, "whisper", SERVE_B * WHISPER_HEADS,
                              WHISPER_TRAIN_B * WHISPER_HEADS,
                              WHISPER_FRAMES, WHISPER_D, False, "wgmma", 37)


# K6 at llava-next-mistral-7b's prefill shape and K7 at its training shape:
# B = 4 x 32 heads of 128 (8 kv heads) over its 2880 stub patches and 1024
# text tokens, causal
LLAVA_HEADS, LLAVA_GROUP, LLAVA_D = 32, 4, 128
LLAVA_PATCHES = 2880
LLAVA_S = LLAVA_PATCHES + SERVE_PROMPT


def check_flash_attention_llava(dev):
    """K6 and K7 causal at llava-next-mistral-7b's shapes (q, o, do (128,
    3904, 128), k, v (32, 3904, 128), group 4; 3904 = 30.5 tiles of 128,
    so the last query and key tiles are ragged), bf16 on the wgmma
    kernels, by :func:`check_attention_at`. Returns (K6's entry, K7's
    entry)."""
    return check_attention_at(dev, "llava", SERVE_B * LLAVA_HEADS,
                              TRAIN_B * LLAVA_HEADS, LLAVA_S, LLAVA_D, True,
                              "wgmma", 41, group=LLAVA_GROUP)


def check_attention_at(dev, tag, bh6, bh7, S, D, causal, variant, seed,
                       group=1):
    """K6 at (bh6, S, D) and K7 at (bh7, S, D) (q, o, do; k, v with
    ``group`` query heads each; ``causal``), bf16 on ``variant``'s
    kernels. K6 held against its plain
    version in bf16 and f32 (:func:`hold_k6_against_plain`; K6 runs on
    the first bh6 query heads of K7's inputs); K7 from K6's o and lse (its lse
    within LSE_TOL of the plain logsumexp) in f32 within BWD_TOL of max
    |grad| and in bf16 no further from the f32 plain gradient than the
    bf16 plain gradient is, x B_RATIO. Each timed in turns with its plain
    version and by its device time, beside its bound and SDPA's time on
    the same inputs (the forward; the forward + backward minus the
    forward). Returns (K6's entry, K7's entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import bwd_kernel as BK
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref as REF

    gen = torch.Generator(device=dev).manual_seed(seed)
    require(K.variant(torch.bfloat16, D, D) == variant,
            f"{tag}'s head dim {D} should run K6's and K7's {variant} "
            f"kernels in bf16")
    mask = "causal" if causal else "full (non-causal)"
    shape6 = (f"q/o ({bh6}, {S}, {D}), k/v ({bh6 // group}, {S}, {D}), "
              f"group {group}, {mask}, bf16 (f32 too)")
    shape7 = (f"q/o/do ({bh7}, {S}, {D}), k/v ({bh7 // group}, {S}, {D}), "
              f"group {group}, {mask}, bf16 (f32 too)")
    pairs = attention_pairs(S, S, causal)
    # the bf16 case is timed; the f32 one is only held
    errs6, ratios6, errs7, lse_errs = {}, {}, {}, {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        want_v = variant if dt == "bfloat16" else "simt"
        q, k, v = attention_inputs(gen, dev, bh7, S, S, D, D, group, dtype)
        do = torch.randn(bh7, S, D, generator=gen, device=dev).to(dtype)
        q6, k6, v6 = q[:bh6], k[:bh6 // group], v[:bh6 // group]
        errs6[dt], ratio = hold_k6_against_plain(f"{tag} {dt}", q6, k6, v6,
                                                 group, causal, want_v)
        if ratio is not None:
            ratios6[dt] = ratio
        o, lse = K.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                        with_lse=True)
        _, want_lse = REF.flash_attention_lse_ref(q, k, v, group=group,
                                                  causal=causal)
        lse_errs[dt] = float((lse - want_lse).abs().max())
        require(lse_errs[dt] <= LSE_TOL,
                f"flash_attention's lse ({tag}, {dt}) differs from the "
                f"plain logsumexp by {lse_errs[dt]:.3e}")
        before = dict(BK.KERNEL.launches_by_variant)
        got = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=group,
                                          causal=causal)
        require(BK.KERNEL.launches_by_variant
                == {**before, want_v: before[want_v] + 1},
                f"flash_attention_bwd ({tag}, {dt}) did not count one "
                f"{want_v} launch")
        want = REF.flash_attention_bwd_ref(q, k, v, o, want_lse, do,
                                           group=group, causal=causal)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(g.float()).all()) for g in got),
                f"flash_attention_bwd ({tag}, {dt}) gave non-finite "
                f"gradients")
        errs7[dt] = grad_err(got, want)
        if dt == "float32":
            require(errs7[dt] <= BWD_TOL,
                    f"flash_attention_bwd ({tag}, f32) differs from its "
                    f"plain version: {errs7[dt]:.3e} of max |grad| > "
                    f"{BWD_TOL:g}")
            del q, k, v, q6, k6, v6, do, o, lse, want_lse, want, got
            torch.cuda.empty_cache()
            continue
        f32 = REF.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), want_lse, do.float(),
            group=group, causal=causal)
        err_k, err_p = grad_err(got, f32), grad_err(want, f32)
        abs7 = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
        log(f"[kernel] flash_attention_bwd at {tag}'s shape, bf16 "
            f"({variant}) vs the f32 plain gradient: kernel {err_k:.3e}, "
            f"plain bf16 {err_p:.3e} (held: kernel <= {B_RATIO:g} x "
            f"plain); kernel vs plain bf16 {errs7[dt]:.3e}")
        require(err_k <= B_RATIO * err_p,
                f"flash_attention_bwd ({tag}, bf16) is further from the f32 "
                "gradient than the plain bf16 gradient is")
        del f32, got, want, want_lse
    torch.cuda.empty_cache()
    log(f"[kernel] {tag}'s attention, K6 {shape6}, K7 {shape7}: K6 max abs "
        f"err vs plain {errs6}, bf16 distance ratio {ratios6}; K7 of max "
        f"|grad| vs plain { {n: f'{e:.3e}' for n, e in errs7.items()} }; "
        f"K6's lse vs the plain logsumexp {lse_errs}")

    def sdpa(bh, backward):
        """SDPA on the first ``bh`` query heads (GQA over their kv heads):
        the forward, or the forward + backward."""
        leaves = [t[:n].detach().clone().view(1, n, S, D).requires_grad_()
                  for t, n in ((q, bh), (k, bh // group), (v, bh // group))]
        grad_out = do[:bh].view(1, bh, S, D)
        kw = dict(is_causal=causal, enable_gqa=group > 1)
        if not backward:
            def fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(*leaves, **kw)
            return fwd

        def fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, **kw)
            torch.autograd.grad(out, leaves, grad_out)
        return fwd_bwd

    fwd6, fwd7, fwd_bwd7 = sdpa(bh6, False), sdpa(bh7, False), sdpa(bh7,
                                                                     True)
    for _ in range(3):                  # its first calls set up
        fwd_bwd7()
        fwd7()
        fwd6()
    torch.cuda.synchronize()
    lib6_ms, lib6_us = time_ms(fwd6, 10), device_us(None, fwd6)
    lib7_ms = time_ms(fwd_bwd7, 10) - time_ms(fwd7, 10)
    lib7_us = device_us(None, fwd_bwd7, 5) - device_us(None, fwd7)
    lib_err = float((fwd6().reshape(bh6, S, D).float()
                     - o[:bh6].float()).abs().max())
    sdpa_call = ("scaled_dot_product_attention(is_causal" if causal else
                 "scaled_dot_product_attention (no mask")
    sdpa_call += ", enable_gqa)" if group > 1 else ")"
    q6, k6, v6 = q[:bh6], k[:bh6 // group], v[:bh6 // group]

    entries = []
    for name, kernel, shape, call, plain, n_ops, n_bytes, lib in (
            ("flash_attention", K.KERNEL, shape6,
             lambda: ops.flash_attention(q6, k6, v6, group=group,
                                         causal=causal),
             lambda: ops.flash_attention(q6, k6, v6, group=group,
                                         causal=causal, backend="ref"),
             2 * (D + D) * pairs * bh6,
             (2 * q6.numel() + k6.numel() + v6.numel()) * 2,
             (lib6_ms, lib6_us,
              f"one {sdpa_call} call; max abs diff to K6 {lib_err:.3e}")),
            ("flash_attention_bwd", BK.KERNEL, shape7,
             lambda: BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                 group=group, causal=causal),
             lambda: REF.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 group=group, causal=causal),
             2 * (2 * D + 2 * D + D) * pairs * bh7,
             2 * S * D * (4 * bh7 + 4 * (bh7 // group)) + 4 * bh7 * S,
             (lib7_ms, lib7_us,
              f"{sdpa_call} forward + backward minus its forward, on the "
              f"same inputs"))):
        ms, plain_ms = in_turns(plain, call, 3)
        dev_time = device_us(kernel, call, 5)
        b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        entries.append({
            "shape": shape, "variant": variant, "ms": ms,
            "plain_ms": plain_ms, "device_us": dev_time, "bound_ms": b_ms,
            "bound_by": b_by, "n_bytes": n_bytes, "n_ops": n_ops,
            "bound_share": b_ms * 1e3 / dev_time, "library_ms": lib[0],
            "library_device_us": lib[1], "library_note": lib[2],
            "max_abs_err": (errs6["bfloat16"] if kernel is K.KERNEL
                            else abs7),
            "errs": errs6 if kernel is K.KERNEL else errs7})
        log(f"[kernel] {name} at {tag}'s shape {shape}: {variant} kernel "
            f"{ms:.5f} ms, device {dev_time:.3f} us, plain {plain_ms:.5f} "
            f"ms, bound {b_ms * 1e3:.3f} us by {b_by} ({n_bytes / 1e6:.1f} "
            f"MB, {n_ops:.4g} operations), {100 * b_ms * 1e3 / dev_time:.2f}"
            f" % of the bound; library {lib[0]:.5f} ms, device "
            f"{lib[1]:.3f} us: the kernel takes {dev_time / lib[1]:.2f}x "
            f"its time ({lib[2]})")
    del q, k, v, q6, k6, v6, o, lse, do
    torch.cuda.empty_cache()
    return entries


# -- the unfused path ----------------------------------------------------------

def unfused_step(system, state, events, now, backend=None):
    """One monitoring period on the unfused, staged path — the paper's
    pre-fusion shape (Fig 3 red, Fig 9) — composed from module entry
    points. It repeats ``DFASystem.ingest_half`` + ``enrich_half``
    (src/repro_torch/core/pipeline.py) stage for stage with three
    substitutions: multipass reporter ingest whose accumulator is the
    flow_moments family; placement through a staging copy
    (``collector.staged_ingest``); the explicit history gather followed by
    the standalone derived_features family in place of the fused gather +
    enrichment. One shard (reporter id 0, flow base 0), run on its view of
    the state as ``ingest_half`` runs each shard. Returns a
    ``StepOutputs``."""
    import torch
    from repro_torch import u32 as U
    from repro_torch.core import collector as COLL
    from repro_torch.core import reporter as REP
    from repro_torch.core import translator as TRANS
    from repro_torch.core import wire as WIRE
    from repro_torch.core.pipeline import (DFAState, StepOutputs, _delta,
                                           _global_seq_gap, _join, _part)
    from repro_torch.kernels.derived_features.ops import derived_features
    from repro_torch.kernels.flow_moments.ops import flow_moments

    cfg, wf = system.cfg, system.wire
    b = backend or system.backend
    rep_st, tr_st, coll_st = (_part(group, 0, 1) for group in state)
    rep_st = REP.ingest(rep_st, events, cfg, accumulate_fn=lambda r, s, d, v:
                        flow_moments(r, s, d, v, backend=b))
    slots, mask = REP.due_flows(rep_st, now, cfg, cfg.report_capacity)
    rep_st, reports = REP.make_reports(rep_st, slots, mask, now, 0, 0, cfg)
    mw = wf.report_meta_word
    meta = wf.set_report_reporter(reports[:, mw],
                                  torch.zeros_like(reports[:, mw]))
    reports[:, mw] = U.narrow(torch.where(mask, meta, 0))
    buckets, bmask, mis = TRANS.route_reports(
        reports, mask, 1, cfg.flows_per_shard, cfg.report_capacity)
    routed = buckets.reshape(-1, wf.report_words)
    rmask = bmask.reshape(-1)
    tr_st, payloads, coords = TRANS.translate(tr_st, routed, rmask, 0, cfg)
    coll_st = COLL.staged_ingest(coll_st, payloads, rmask, 0, cfg, backend=b)
    rep_st, tr_st, coll_st = (_join([part], group) for part, group in
                              zip((rep_st, tr_st, coll_st), state))
    coll_st, lost_delta = _global_seq_gap(coll_st, state.collector)
    metrics = {"reports_sent": mask.sum(), "reports_recv": rmask.sum(),
               "bucket_drops": mask.sum() - bmask.sum() - mis,
               "misroutes": mis,
               "collisions": _delta(rep_st.collisions,
                                    state.reporter.collisions),
               "bad_checksum": _delta(coll_st.bad_checksum,
                                      state.collector.bad_checksum),
               "seq_anomalies": _delta(coll_st.seq_anomalies,
                                       state.collector.seq_anomalies),
               "lost_reports": lost_delta}
    entries, ev = COLL.gather_flow_history(coll_st, coords["local_flow"])
    enriched = derived_features(entries, ev, cfg, backend=b)
    enriched = torch.where(rmask[:, None], enriched, torch.zeros_like(enriched))
    flow_ids = torch.where(rmask, U.wide(routed[:, 0]), WIRE.PAD_FLOW_ID)
    preds = None
    if system.head is not None:
        preds = system.head(enriched)
        preds = torch.where(rmask[:, None], preds, torch.zeros_like(preds))
    return StepOutputs(DFAState(rep_st, tr_st, coll_st), enriched, flow_ids,
                       rmask, metrics, preds)


# -- phase 4: the main path ---------------------------------------------------

def paper_dfa(dev, **changes):
    """DFASystem on the PAPER config (with ``changes``) and an mlp head of
    seeded random weights, the same in every phase."""
    from repro_torch.configs import PAPER
    from repro_torch.core.pipeline import DFASystem

    cfg = dataclasses.replace(PAPER, inference_head="mlp", **changes)
    rng = np.random.default_rng(0)
    D, Hd, C = cfg.derived_dim, cfg.inference_hidden, cfg.inference_classes
    params = {"w1": 0.1 * rng.standard_normal((D, Hd), np.float32),
              "b1": np.zeros(Hd, np.float32),
              "w2": 0.1 * rng.standard_normal((Hd, C), np.float32),
              "b2": np.zeros(C, np.float32)}
    return DFASystem(cfg, device=dev, infer_params=params)


def paper_system(dev):
    """The PAPER system (V1 wire) and the main path's traffic: T_MAIN + 1
    periods of 2^20 events."""
    import torch
    from repro_torch.data import packets as PK

    system = paper_dfa(dev)
    cfg = system.cfg
    t0 = time.perf_counter()
    events, nows = PK.period_batches(
        1, T_MAIN + 1, EVENTS, n_flows=cfg.flows_per_shard, flow_seed=0,
        period_us=cfg.monitoring_period_us,
        window_us=cfg.monitoring_period_us, device=dev)
    torch.cuda.synchronize()
    log(f"[main] traffic: {T_MAIN + 1} periods x {EVENTS} events from "
        f"{cfg.flows_per_shard} flows, made in "
        f"{time.perf_counter() - t0:.3f} s")
    return system, events, nows


def check_outputs(outs, cfg, tag):
    """Every period: sent == received, no bad checksum, finite features
    and preds of the expected shapes."""
    import torch
    D, C = cfg.derived_dim, cfg.inference_classes
    for t, out in enumerate(outs):
        m = {k: int(v) for k, v in out.metrics.items()}
        require(m["reports_sent"] == m["reports_recv"],
                f"[{tag}] period {t}: sent {m['reports_sent']} != recv "
                f"{m['reports_recv']}")
        require(m["bad_checksum"] == 0, f"[{tag}] period {t}: bad checksums")
        require(out.enriched.shape == (cfg.report_capacity, D)
                and bool(torch.isfinite(out.enriched).all()),
                f"[{tag}] period {t}: features not finite / wrong shape")
        require(out.preds.shape == (cfg.report_capacity, C)
                and bool(torch.isfinite(out.preds).all()),
                f"[{tag}] period {t}: preds not finite / wrong shape")


def compare_outputs(o, r, t, tag):
    """One period's outputs against the reference run's: routed flows
    and metrics exact, features row-scaled (their non-finite entries bit
    for bit), preds when a head is armed; returns (row-scaled feature
    err, preds max abs err) after checking both against their
    tolerances."""
    import torch
    require(torch.equal(o.flow_ids, r.flow_ids) and torch.equal(o.mask, r.mask),
            f"[{tag}] period {t}: routed flows differ")
    require(sorted(o.metrics) == sorted(r.metrics),
            f"[{tag}] period {t}: metric keys differ")
    for k in o.metrics:
        require(torch.equal(o.metrics[k], r.metrics[k]),
                f"[{tag}] period {t}: metric {k} differs")
    odd = ~torch.isfinite(r.enriched)
    require(torch.equal(o.enriched[odd].view(torch.int32),
                        r.enriched[odd].view(torch.int32)),
            f"[{tag}] period {t}: non-finite features differ")
    err = feature_err(torch.where(odd, 0.0, o.enriched),
                      torch.where(odd, 0.0, r.enriched))
    require(err <= FEATURE_TOL,
            f"[{tag}] period {t}: features differ, row-scaled {err:.3e}")
    if o.preds is None:
        return err, 0.0
    require(torch.allclose(o.preds, r.preds, rtol=PRED_TOL, atol=PRED_TOL),
            f"[{tag}] period {t}: preds differ")
    return err, float((o.preds - r.preds).abs().max())


def timed_periods(system, events, nows, backend=None, periods=None):
    """``dfa_step`` period by period from a fresh state, each timed on the
    host clock to ``synchronize()``. Returns (state, outputs, ms)."""
    import torch
    state = system.init_state()
    outs, period_ms = [], []
    torch.cuda.synchronize()
    for t in range(periods or len(nows)):
        t0 = time.perf_counter()
        out = system.dfa_step(state, {k: v[t] for k, v in events.items()},
                              nows[t], backend=backend)
        torch.cuda.synchronize()
        period_ms.append((time.perf_counter() - t0) * 1e3)
        state = out.state
        outs.append(out)
    return state, outs, period_ms


def require_states_equal(a, b, tag):
    """Two port states, every leaf bit for bit."""
    import torch
    for group, ga, gb in zip(a._fields, a, b):
        for f, x, y in zip(ga._fields, ga, gb):
            require(torch.equal(x, y), f"[{tag}] {group}.{f} differs")


def main_path(system, events, nows):
    """The PAPER main path (V1 wire) with every launch counted, then the
    plain run; returns (launches, per-period seq_anomalies)."""
    import torch
    from repro_torch.convert import state_to_numpy

    cfg = system.cfg

    def run(backend):
        return timed_periods(system, events, nows, backend, T_MAIN + 1)

    from repro_torch.kernels.gather_enrich.kernel import KERNEL as K3
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2
    kernels = (K1, K2, K3)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset_counts()
    state, outs, period_ms = run(None)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        require(launches[k.name] >= T_MAIN,
                f"{k.name} launched {launches[k.name]} times on the main "
                f"path, expected >= {T_MAIN}")
    check_outputs(outs, cfg, "main")
    timed = period_ms[1:]
    vectors = sum(int(o.mask.sum()) for o in outs[1:])
    log(f"[main] metrics per period: "
        f"{[{k: int(v) for k, v in o.metrics.items()} for o in outs]}")
    log(f"[main] per-period ms (kernels; warm-up {period_ms[0]:.3f}): "
        f"{[round(x, 3) for x in timed]}")
    log(f"[main] mean period ms {np.mean(timed):.4f}, median "
        f"{np.median(timed):.4f}; feature vectors/s "
        f"{vectors / (sum(timed) / 1e3):.1f}; max_memory_allocated "
        f"{peak} B; launches {launches}")

    profile_periods(system.dfa_step, system.init_state(), events, nows,
                    "main")

    ref_state, ref_outs, ref_ms = run("ref")
    log(f"[main] per-period ms (plain versions, backend='ref'): "
        f"{[round(x, 3) for x in ref_ms[1:]]}, mean "
        f"{np.mean(ref_ms[1:]):.4f}")
    a, b = state_to_numpy(state), state_to_numpy(ref_state)
    for group in ("reporter", "translator", "collector"):
        ga, gb = getattr(a, group), getattr(b, group)
        for f in ga._fields:
            require(np.array_equal(getattr(ga, f), getattr(gb, f)),
                    f"kernel run and plain run differ on {group}.{f}")
    errs = [compare_outputs(o, r, t, "main vs plain")
            for t, (o, r) in enumerate(zip(outs, ref_outs))]
    log(f"[main] kernel run == plain run: integer state bitwise, features "
        f"row-scaled err {max(e for e, _ in errs):.3e}, preds max abs err "
        f"{max(p for _, p in errs):.3e} (tolerance rtol=atol={PRED_TOL:g})")
    return launches, [int(o.metrics["seq_anomalies"]) for o in outs]


def profile_periods(step, state, events, nows, tag, periods: int = 2):
    """torch.profiler over ``periods`` steady periods of ``step(state,
    events_t, now_t)`` (after one period outside the window). Runs after
    the launch counts were read."""
    import torch
    box = [step(state, {k: v[0] for k, v in events.items()}, nows[0]).state]
    torch.cuda.synchronize()
    t = iter(range(1, periods + 1))

    def one():
        i = next(t)
        box[0] = step(box[0], {k: v[i] for k, v in events.items()},
                      nows[i]).state
    return profile_window(tag, one, periods, "period")


def profile_window(tag, fn, n: int, unit: str = "request"):
    """torch.profiler over ``n`` calls of ``fn``: device time by kernel
    name (top 15), the device's busy share of the wall time, and the host
    ops with the most self time, each per ``unit``. Returns the wall and
    device-busy µs per ``unit``, the idle share and the device kernels
    per ``unit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device-side events only: an aten op's own entry repeats the time
    # of the kernels it launched
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    log(f"[profile {tag}] {n} {unit}s: wall {wall_us:.1f} us, device "
        f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 - 100 * busy_us / wall_us:.1f} %")
    launches = sum(e.count for e in rows) / n
    log(f"[profile {tag}] device kernels per {unit}: {launches:.0f}")
    for e in rows[:15]:
        log(f"[profile {tag}]   {dev_us(e) / n:10.1f} us/{unit}  "
            f"{e.count // n:5d} calls/{unit}  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in host)
    log(f"[profile {tag}] host self time per {unit} "
        f"{host_us / n:.1f} us (profiler overhead included); top ops:")
    for e in host[:10]:
        log(f"[profile {tag}]   {e.self_cpu_time_total / n:10.1f} "
            f"us/{unit}  {e.count // n:5d} calls/{unit}  {e.key[:60]}")
    return {"wall_us": wall_us / n, "busy_us": busy_us / n,
            "idle_share": 1 - busy_us / wall_us, "kernels": launches}


# -- phase 5: the unfused path --------------------------------------------------

def unfused_path(system, events, nows):
    """The unfused path over the main path's first T_UNFUSED + 1 periods
    (launch counts from 0, per-period wall times), then the fused main
    path over the same periods: every period's integer state bit for bit,
    metrics exact, features row-scaled, preds 1e-5."""
    import torch
    from repro_torch.kernels.derived_features.kernel import KERNEL as K5
    from repro_torch.kernels.flow_moments.kernel import KERNEL as K4
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2

    periods = T_UNFUSED + 1
    kernels = (K4, K5, K2)

    def snapshot(state):
        return [t.clone() for group in state for t in group]

    state, outs, snaps, period_ms, per_period = (system.init_state(), [],
                                                 [], [], [])
    torch.cuda.synchronize()
    for k in kernels:
        k.reset_counts()
    for t in range(periods):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        out = unfused_step(system, state, {k: v[t] for k, v in
                                           events.items()}, nows[t])
        torch.cuda.synchronize()
        period_ms.append((time.perf_counter() - t0) * 1e3)
        per_period.append({k.name: k.launches - n
                           for k, n in zip(kernels, before)})
        state = out.state
        outs.append(out)
        snaps.append(snapshot(state))
    launches = {k.name: k.launches for k in kernels}
    for t, counts in enumerate(per_period):
        for name, n in counts.items():
            require(n >= 1, f"[unfused] period {t}: {name} was not launched")
    check_outputs(outs, system.cfg, "unfused")
    timed = period_ms[1:]
    log(f"[unfused] per-period ms (warm-up {period_ms[0]:.3f}): "
        f"{[round(x, 3) for x in timed]}; mean {np.mean(timed):.4f}, median "
        f"{np.median(timed):.4f}; launches {launches} "
        f"(per period {per_period[-1]})")

    profile_periods(lambda st, ev, now: unfused_step(system, st, ev, now),
                    system.init_state(), events, nows, "unfused")

    state, fused_ms, errs = system.init_state(), [], []
    torch.cuda.synchronize()
    for t in range(periods):
        t0 = time.perf_counter()
        ref = system.dfa_step(state, {k: v[t] for k, v in events.items()},
                              nows[t])
        torch.cuda.synchronize()
        fused_ms.append((time.perf_counter() - t0) * 1e3)
        state = ref.state
        names = [f"{g}.{f}" for g, group in zip(state._fields, state)
                 for f in group._fields]
        for name, a, b in zip(names, snaps[t], snapshot(state)):
            require(torch.equal(a, b), f"[unfused] period {t}: {name} "
                                       "differs from the fused main path")
        errs.append(compare_outputs(outs[t], ref, t, "unfused vs fused"))
    log(f"[unfused] == fused main path over {periods} periods: integer "
        f"state bitwise, metrics equal, features row-scaled err "
        f"{max(e for e, _ in errs):.3e}, preds max abs err "
        f"{max(p for _, p in errs):.3e}")
    log(f"[unfused] fused per-period ms in the same phase (warm-up "
        f"{fused_ms[0]:.3f}): {[round(x, 3) for x in fused_ms[1:]]}; mean "
        f"{np.mean(fused_ms[1:]):.4f} vs unfused {np.mean(timed):.4f}")
    return launches


# -- phases 6-8 and 11: the online serving slice at PAPER under the V2 wire --

LINE_RATE_EPS = EVENTS / 0.02        # 2^20 events per 20 ms period
SERVE_PERIODS = 1000                 # [serving] main run
SERVE_SNAPSHOT_EVERY = 250
SERVE_COMPARE = 40                   # kernels vs plain serving periods
SERVE_OVERRUN = 50                   # 1.5x line rate, then the drain
FAULT_PERIODS = 5
# tests/test_fault_injection.py's MIXED spec
MIXED = dict(seed=7, drop_rate=0.15, dup_rate=0.1, flip_rate=0.1,
             replay_rate=0.05, reorder_rate=0.3, reorder_window=4)


def v2_phase(dev, events, nows, v1_anomalies):
    """The PAPER main path under the V2 wire: kernel run == plain run,
    and no report rejected (V1 rejects 3840 of 4096 per period)."""
    system = paper_dfa(dev, wire_format="v2")
    state, outs, ms = timed_periods(system, events, nows)
    ref_state, ref_outs, ref_ms = timed_periods(system, events, nows, "ref")
    check_outputs(outs, system.cfg, "v2")
    for t, o in enumerate(outs):
        m = {k: int(v) for k, v in o.metrics.items()}
        require(m["seq_anomalies"] == 0,
                f"[v2] period {t}: {m['seq_anomalies']} seq anomalies")
        require(m["reports_recv"] == m["reports_sent"],
                f"[v2] period {t}: recv {m['reports_recv']} != sent "
                f"{m['reports_sent']}")
    require_states_equal(state, ref_state, "v2 kernels vs plain")
    errs = [compare_outputs(o, r, t, "v2 vs plain")
            for t, (o, r) in enumerate(zip(outs, ref_outs))]
    log(f"[v2] PAPER V2, {len(outs)} periods: seq_anomalies "
        f"{[int(o.metrics['seq_anomalies']) for o in outs]} (V1 main path: "
        f"{v1_anomalies}); reports recv/sent "
        f"{[int(o.metrics['reports_recv']) for o in outs]}")
    log(f"[v2] per-period ms (kernels; warm-up {ms[0]:.3f}): "
        f"{[round(x, 3) for x in ms[1:]]}, mean {np.mean(ms[1:]):.4f}; "
        f"plain mean {np.mean(ref_ms[1:]):.4f}")
    log(f"[v2] kernel run == plain run: integer state bitwise, features "
        f"row-scaled err {max(e for e, _ in errs):.3e}, preds max abs err "
        f"{max(p for _, p in errs):.3e}")


def overlap_phase(dev, events, nows):
    """Overlapped driver == sequential driver, bit for bit, at PAPER V2."""
    import torch
    system = paper_dfa(dev, wire_format="v2")
    walls = {}
    runs = {}
    for name in ("sequential", "overlapped", "sequential ", "overlapped "):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name.strip()] = system.stream(system.init_state(), events, nows,
                                           overlapped=name.startswith("o"))
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
    a, b = runs["sequential"], runs["overlapped"]
    require_states_equal(a.state, b.state, "overlap")
    for f in ("enriched", "flow_ids", "mask", "preds"):
        require(torch.equal(getattr(a, f), getattr(b, f)),
                f"[overlap] {f} differs from the sequential driver")
    require(sorted(a.metrics) == sorted(b.metrics), "[overlap] metric keys")
    for k in a.metrics:
        require(torch.equal(a.metrics[k], b.metrics[k]), f"[overlap] {k}")
    T = len(nows)
    log(f"[overlap] PAPER V2, {T} periods: overlapped == sequential bit for "
        f"bit (state, features, preds, metrics); wall ms for {T} periods, "
        f"in turns: " + ", ".join(f"{k.strip()} {v:.3f}"
                                  for k, v in walls.items()))


def faults_phase(dev, events, nows):
    """PAPER V2 with the MIXED fault spec over FAULT_PERIODS periods: the
    three accounting identities exactly, every period, and the kernel run
    == the plain run under the same draws."""
    from repro_torch.data.faults import FaultSpec
    system = paper_dfa(dev, wire_format="v2", fault_spec=FaultSpec(**MIXED))
    state, outs, ms = timed_periods(system, events, nows,
                                    periods=FAULT_PERIODS)
    ref_state, ref_outs, _ = timed_periods(system, events, nows, "ref",
                                           periods=FAULT_PERIODS)
    rows = []
    for t, o in enumerate(outs):
        m = {k: int(v) for k, v in o.metrics.items() if v.dim() == 0}
        ident = (m["bad_checksum"] == m["injected_flips"],
                 m["seq_anomalies"] == m["injected_dups"]
                 + m["injected_replays"],
                 m["lost_reports"] == m["injected_drops"]
                 + m["injected_flips"])
        require(all(ident), f"[faults] period {t}: identities {ident} "
                            f"fail on {m}")
        rows.append({k: m[k] for k in (
            "injected_drops", "injected_dups", "injected_flips",
            "injected_replays", "injected_reorders", "bad_checksum",
            "seq_anomalies", "lost_reports")})
    require_states_equal(state, ref_state, "faults kernels vs plain")
    import torch
    for t, (o, r) in enumerate(zip(outs, ref_outs)):
        for k in o.metrics:
            require(torch.equal(o.metrics[k], r.metrics[k]),
                    f"[faults] period {t}: {k} differs from the plain run")
        require(feature_err(o.enriched, r.enriched) <= FEATURE_TOL,
                f"[faults] period {t}: features differ")
    log(f"[faults] PAPER V2, MIXED {MIXED}, {FAULT_PERIODS} periods: "
        f"identities exact every period: {rows}")
    log(f"[faults] ring_scatter rows per period "
        f"{int(outs[0].metrics['fault_kind'].shape[-1])} (2R, R = "
        f"{system.cfg.report_capacity}); kernel run == plain run (state "
        f"bitwise, metrics and ledger equal); per-period ms "
        f"{[round(x, 3) for x in ms]}")


def runs_of(values):
    """Run-length encoding [[value, count], ...] of a sequence."""
    out = []
    for v in values:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return out


def serving_profile(run, periods: int):
    """torch.profiler over ``run(periods)`` (a serving run whose loop and
    state were made outside the window): device busy and idle share,
    device kernels, and the CUDA runtime calls the host made, per
    period."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(periods)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    dev_rows = [e for e in ev
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in dev_rows)
    require(busy > 0, "[serving profile] the profiler saw no device time")
    runtime = {e.key: e.count / periods for e in ev
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("cuda")}

    def calls(name):
        return sum(n for k, n in runtime.items() if k.startswith(name))

    return {"wall_us": wall_us / periods, "busy_us": busy / periods,
            "idle_share": 1 - busy / wall_us,
            "kernels": sum(e.count for e in dev_rows) / periods,
            "cudaLaunchKernel": calls("cudaLaunchKernel"),
            "cudaStreamSynchronize": calls("cudaStreamSynchronize"),
            "cudaMemcpyAsync": calls("cudaMemcpyAsync"),
            "runtime": runtime}


def serving_phase(dev, events, nows):
    """ServingLoop at PAPER V2 with the mlp head at line rate for
    SERVE_PERIODS periods (launch counts from 0), snapshots every
    SERVE_SNAPSHOT_EVERY periods; the newest snapshot restored to the
    card equals the end state; a kernel run and a plain run of
    SERVE_COMPARE periods give the same metrics and state; 1.5x line rate
    with a 2^21-event queue balances after the drain with drops; a
    profile of 2 periods with the host -> device copies cached and with
    them made per call (the code before this slice)."""
    import tempfile

    import torch
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.core import logstar as LS
    from repro_torch.core import protocol as PROTO
    from repro_torch.launch.serving import ServingLoop, build_source

    knobs = dict(wire_format="v2", serve_offered_eps=LINE_RATE_EPS,
                 serve_budget_us=20_000, serve_queue_events=0)
    host_ev = {k: v.cpu() for k, v in events.items()}

    def loop(system, snapshot_dir=None):
        return ServingLoop(system, build_source(system, host_ev, nows,
                                                batch_events=EVENTS),
                           snapshot_dir=snapshot_dir)

    system = paper_dfa(dev, snapshot_every_periods=SERVE_SNAPSHOT_EVERY,
                       snapshot_keep=3, **knobs)
    loop(system).run(2)                       # warm-up, outside the counts
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        for k in all_kernels():
            k.reset_counts()
        t0 = time.perf_counter()
        rep = loop(system, d).run(SERVE_PERIODS)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in all_kernels()[:3]}
        peak = torch.cuda.max_memory_allocated()
        for name, n in launches.items():
            require(n >= SERVE_PERIODS, f"[serving] {name} launched {n} "
                                        f"times in {SERVE_PERIODS} periods")
        require(rep.balanced and rep.dropped == 0,
                f"[serving] accounting: offered {rep.offered}, processed "
                f"{rep.processed}, dropped {rep.dropped}")
        steps = CKPT.list_steps(d)
        restored, step = CKPT.restore(d, device=dev)
        require(step == SERVE_PERIODS and rep.snapshots == SERVE_PERIODS
                // SERVE_SNAPSHOT_EVERY, f"[serving] snapshots {steps}, "
                                         f"{rep.snapshots} written")
        require_states_equal(restored, rep.last.state,
                             "serving: restored snapshot vs end state")
    lat = rep.latency
    m = {k: v.cpu().numpy() for k, v in rep.metrics.items()}
    split = {k: (float(np.mean(v)), float(np.percentile(v, 50)),
                 float(np.percentile(v, 99)))
             for k, v in rep.host_us.items()}
    log(f"[serving] PAPER V2 + mlp head, {SERVE_PERIODS} periods of "
        f"{EVENTS} events offered at {LINE_RATE_EPS:.0f} events/s, budget "
        f"{rep.budget_us} us: p50 {lat['p50']:.1f} us, p99 "
        f"{lat['p99']:.1f} us, p999 {lat['p999']:.1f} us "
        f"(count {lat['count']}); SLO violations {rep.violations}; "
        f"sustained {rep.sustained_eps:.0f} events/s; balanced "
        f"{rep.balanced}; wall {wall:.3f} s; snapshots {rep.snapshots} "
        f"(kept {steps}), restored step {step} == end state bitwise; "
        f"max_memory_allocated {peak} B; launches {launches}")
    log("[serving] host us per period (mean, p50, p99): " + ", ".join(
        f"{k} {a:.1f} / {b:.1f} / {c:.1f}" for k, (a, b, c) in split.items()))
    log(f"[serving] reports sent/recv per period (runs): "
        f"{runs_of(m['reports_sent'].tolist())} / "
        f"{runs_of(m['reports_recv'].tolist())}")
    log(f"[serving] seq_anomalies per period (runs of [value, periods]): "
        f"{runs_of(m['seq_anomalies'].tolist())}")
    log(f"[serving] lost_reports per period (runs): "
        f"{runs_of(m['lost_reports'].tolist())}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serving_periods.json").write_text(json.dumps({
        "latency_us": rep.latency_us, "host_us": rep.host_us,
        "metrics": {k: v.tolist() for k, v in m.items()}}))

    # kernels vs plain over SERVE_COMPARE periods
    reports = {}
    for backend in ("auto", "ref"):
        s = paper_dfa(dev, kernel_backend=backend, **knobs)
        reports[backend] = loop(s).run(SERVE_COMPARE)
    a, b = reports["auto"], reports["ref"]
    for k in a.metrics:
        require(torch.equal(a.metrics[k], b.metrics[k]),
                f"[serving] {k} differs between the kernel and plain runs")
    require_states_equal(a.last.state, b.last.state,
                         "serving kernels vs plain")
    log(f"[serving] {SERVE_COMPARE} periods, kernels vs plain: per-period "
        f"metrics equal, end state bitwise; p50 {a.latency['p50']:.1f} vs "
        f"{b.latency['p50']:.1f} us")

    # 1.5x line rate into a queue of 2 batches (2^21 events), then the
    # drain
    s = paper_dfa(dev, **dict(knobs, serve_offered_eps=1.5 * LINE_RATE_EPS,
                              serve_queue_events=2 * EVENTS))
    over = loop(s).run(SERVE_OVERRUN)
    require(over.balanced and over.dropped > 0 and over.drained_periods > 0,
            f"[serving] overrun: offered {over.offered}, processed "
            f"{over.processed}, dropped {over.dropped}, drained "
            f"{over.drained_periods}")
    log(f"[serving] 1.5x line rate, queue {2 * EVENTS}, {SERVE_OVERRUN} "
        f"periods + "
        f"{over.drained_periods} drained: offered {over.offered}, processed "
        f"{over.processed}, dropped {over.dropped}, balanced "
        f"{over.balanced}; p50 {over.latency['p50']:.1f} us, p99 "
        f"{over.latency['p99']:.1f} us, violations {over.violations}")

    # 2 profiled periods (after 2 outside the window): host -> device
    # copies cached (this code), then made on every call as before this
    # slice
    def prof_run():
        lp, st = loop(system), system.init_state()
        lp.run(2, drain=False, state=st)
        return lambda n: lp.run(n, drain=False, state=st)

    after = serving_profile(prof_run(), 2)
    cached = (LS._lut_tensors, PROTO._covered_positions)
    LS._lut_tensors = LS._lut_tensors.__wrapped__
    PROTO._covered_positions = PROTO._covered_positions.__wrapped__
    try:
        before = serving_profile(prof_run(), 2)
    finally:
        LS._lut_tensors, PROTO._covered_positions = cached
    for tag, p in (("copies cached", after), ("copies per call", before)):
        log(f"[serving profile] {tag}, per period of 2: wall "
            f"{p['wall_us']:.1f} us, device busy {p['busy_us']:.1f} us, idle "
            f"{100 * p['idle_share']:.1f} %, {p['kernels']:.1f} device "
            f"kernels, cudaLaunchKernel {p['cudaLaunchKernel']:.1f}, "
            f"cudaStreamSynchronize {p['cudaStreamSynchronize']:.1f}, "
            f"cudaMemcpyAsync {p['cudaMemcpyAsync']:.1f}; runtime calls "
            f"{ {k: round(v, 1) for k, v in p['runtime'].items()} }")
    return launches


# -- phases 9-10: the emulated meshes at PAPER width --------------------------

MESH_SHARDS = 4
MESH_PERIODS = 4
MESH_FLOWS = 1 << 19          # [mesh2d]'s flow population
MESH_SLOTS = 1 << 17          # [mesh2d]'s reporter slots and ring per device
MESH_PORT_REPORTS = 4096      # [mesh2d]'s due reports per port and period
MESH_GRID = (1, 2, 4)         # pods of the (pods, 4 // pods) meshes


def path_kernels():
    """The main path's kernels: K1 ingest_segment_sums, K2 ring_scatter,
    K3 gather_enrich."""
    from repro_torch.kernels.gather_enrich.kernel import KERNEL as K3
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2
    return (K1, K2, K3)


def counted_periods(system, events, nows, tag, backend=None):
    """``timed_periods`` from launch counts of 0; requires every path
    kernel to have launched. Returns (state, outputs, ms, launches)."""
    kernels = path_kernels()
    for k in kernels:
        k.reset_counts()
    state, outs, ms = timed_periods(system, events, nows, backend)
    launches = {k.name: k.launches for k in kernels}
    for name, n in launches.items():
        require(n >= len(nows), f"[{tag}] {name} launched {n} times in "
                                f"{len(nows)} periods")
    return state, outs, ms, launches


def runs_err(a, b, tag) -> float:
    """Two runs of one system, period by period (``compare_outputs``);
    returns the largest row-scaled feature error."""
    return max(compare_outputs(o, r, t, tag)[0]
               for t, (o, r) in enumerate(zip(a, b)))


def require_accounting(outs, tag, drops_allowed: bool):
    """Every period: sent == received + bucket drops + misroutes, and
    something was received."""
    for t, o in enumerate(outs):
        m = {k: int(v) for k, v in o.metrics.items() if v.dim() == 0}
        require(m["reports_sent"] == m["reports_recv"] + m["bucket_drops"]
                + m["misroutes"] and m["reports_recv"] > 0,
                f"[{tag}] period {t}: accounting {m}")
        require(drops_allowed or m["bucket_drops"] == 0,
                f"[{tag}] period {t}: {m['bucket_drops']} bucket drops")


def mesh1d_phase(dev):
    """[mesh1d] The 1-D shard mesh at PAPER per-shard shapes (V1, 2^17
    flows, 10-entry ring, 4096 reports per period), 4 shards on one card,
    flow_home="ingest": the main path's trace laid out 4 x 2^20 events per
    period for MESH_PERIODS periods. Kernel run (launches from 0) == plain
    run; the report accounting closes every period. Returns launches."""
    import torch
    from repro_torch.configs import PAPER
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK

    n = MESH_SHARDS
    system = DFASystem(PAPER, device=dev, n_shards=n)
    t0 = time.perf_counter()
    events, nows = PK.period_batches(
        n, MESH_PERIODS, EVENTS, n_flows=PAPER.flows_per_shard, flow_seed=0,
        period_us=PAPER.monitoring_period_us,
        window_us=PAPER.monitoring_period_us, device=dev)
    torch.cuda.synchronize()
    log(f"[mesh1d] traffic: {MESH_PERIODS} periods x {n} x {EVENTS} events "
        f"(the main path's trace, one slice per shard), made in "
        f"{time.perf_counter() - t0:.3f} s")
    state, outs, ms, launches = counted_periods(system, events, nows,
                                                "mesh1d")
    require_accounting(outs, "mesh1d", drops_allowed=True)
    R = n * max(1, PAPER.report_capacity // n)
    for t, o in enumerate(outs):
        require(o.enriched.shape == (n * R, PAPER.derived_dim),
                f"[mesh1d] period {t}: features {tuple(o.enriched.shape)}")
    ref_state, ref_outs, ref_ms = timed_periods(system, events, nows, "ref")
    require_states_equal(state, ref_state, "mesh1d kernels vs plain")
    err = runs_err(outs, ref_outs, "mesh1d kernels vs plain")
    prof = profile_periods(system.dfa_step, system.init_state(), events,
                           nows, "mesh1d")
    nonfinite = sum(int((~torch.isfinite(o.enriched)).sum()) for o in outs)
    log(f"[mesh1d] PAPER V1, {n} shards x 2^17 flows, {MESH_PERIODS} "
        f"periods: metrics per period "
        f"{[{k: int(v) for k, v in o.metrics.items()} for o in outs]}")
    log(f"[mesh1d] per-period ms (kernels): {[round(x, 3) for x in ms]}, "
        f"mean after the first {np.mean(ms[1:]):.4f}; plain "
        f"{[round(x, 3) for x in ref_ms]}; launches {launches} "
        f"({ {k: v / MESH_PERIODS for k, v in launches.items()} } per "
        f"period); device idle {100 * prof['idle_share']:.1f} % "
        f"({prof['kernels']:.0f} device kernels per period)")
    log(f"[mesh1d] kernel run == plain run: integer state bitwise, metrics "
        f"equal, features row-scaled err {err:.3e}; sent == recv + drops + "
        f"misroutes every period; non-finite features {nonfinite}")
    return launches


def mesh2d_cfg(pods: int, **changes):
    """[mesh2d]'s configuration: PAPER width under V2, flow_home="hash",
    one port per device (4 // pods per pod), 2^17 reporter slots per port,
    4096 due reports per port, the global keyspace fixed at 4 x 2^17."""
    from repro_torch.configs import PAPER
    kw = dict(wire_format="v2", flow_home="hash", pods=pods,
              ports_per_pod=MESH_SHARDS // pods, reporter_slots=MESH_SLOTS,
              flows_per_shard=MESH_SHARDS * MESH_SLOTS // MESH_SHARDS,
              port_report_capacity=MESH_PORT_REPORTS)
    return dataclasses.replace(PAPER, **{**kw, **changes})


def merged_state(system, state):
    """The mesh-shape-independent view of a state (the merge of
    tests/test_multipod_equiv.py::_merged_state): reporter and the
    stacked translator / collector tables as they are, ``last_seq`` by
    an elementwise max over devices, the scalar counters summed."""
    import torch
    from repro_torch import u32 as U
    n = system.n_shards
    out = {f"rep.{k}": v for k, v in state.reporter._asdict().items()}
    out["tr.hist_counter"] = state.translator.hist_counter
    c = state.collector
    out["coll.memory"] = c.memory
    out["coll.entry_valid"] = c.entry_valid
    out["coll.last_seq"] = U.wide(c.last_seq).view(n, -1).amax(0)
    for k in ("bad_checksum", "seq_anomalies", "received", "lost_reports"):
        out[f"coll.{k}"] = U.wide(getattr(c, k)).sum().reshape(1)
    return {k: v.reshape(-1).view(torch.uint8) if v.dtype == torch.bool
            else v for k, v in out.items()}


def canon_periods(outs):
    """Per period: the flow-sorted ids and feature rows (bits) of the
    valid rows (tests/test_multipod_equiv.py::_canon_periods): the
    mesh-invariant content of a period's output."""
    import torch
    per = []
    for o in outs:
        fid = o.flow_ids[o.mask]
        order = torch.sort(fid, stable=True).indices
        per.append({"fid": fid[order],
                    "enr": o.enriched[o.mask][order].view(torch.int32)})
    return per


def require_invariant(a, b, tag, metrics=None):
    """Merged states, flow-sorted outputs and metrics, bit for bit."""
    import torch
    (sa, pa, ma), (sb, pb, mb) = a, b
    for k in sa:
        require(torch.equal(sa[k], sb[k]), f"[{tag}] state {k} differs")
    for t, (x, y) in enumerate(zip(pa, pb)):
        for k in x:
            require(torch.equal(x[k], y[k]), f"[{tag}] period {t}: {k}")
    for t, (x, y) in enumerate(zip(ma, mb)):
        for k in (metrics or x):
            require(torch.equal(x[k], y[k]), f"[{tag}] period {t}: metric "
                                             f"{k} differs")


def mesh2d_phase(dev):
    """[mesh2d] The 2-D (pod, shard) mesh at PAPER width under V2 (see
    ``mesh2d_cfg``), 2^20 events per port per period from 2^19 flows,
    port-major, MESH_PERIODS periods, all with the kernels: the (1,4),
    (2,2) and (4,1) meshes give the same merged state and flow-sorted
    outputs bit for bit; on (2,2) (launches from 0) kernels == plain,
    ragged == padded, rendezvous kernels == plain and overlapped ==
    sequential. Returns (launches, the trace's events and nows)."""
    import torch
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK

    n = MESH_SHARDS
    t0 = time.perf_counter()
    events, nows = PK.period_batches(
        n, MESH_PERIODS, EVENTS, n_flows=MESH_FLOWS, flow_seed=1,
        period_us=20_000, window_us=20_000, device=dev)
    torch.cuda.synchronize()
    log(f"[mesh2d] traffic: {MESH_PERIODS} periods x {n} ports x {EVENTS} "
        f"events from {MESH_FLOWS} flows, port-major, made in "
        f"{time.perf_counter() - t0:.3f} s")

    def system(pods, **changes):
        return DFASystem(mesh2d_cfg(pods, **changes), device=dev, n_shards=n)

    def view(s, outs, state):
        return (merged_state(s, state), canon_periods(outs),
                [o.metrics for o in outs])

    views, main = {}, None
    for pods in MESH_GRID:
        s = system(pods)
        if pods == 2:
            state, outs, ms, launches = counted_periods(s, events, nows,
                                                        "mesh2d")
            main = (s, state, outs, ms)
        else:
            state, outs, _ = timed_periods(s, events, nows)
        require_accounting(outs, f"mesh2d ({pods},{n // pods})",
                           drops_allowed=False)
        views[pods] = view(s, outs, state)
        d = s.describe()
        log(f"[mesh2d] ({pods},{n // pods}): describe " + str(
            {k: d[k] for k in ("pods", "shards_per_pod", "total_ports",
                               "ports_per_device", "port_report_capacity",
                               "stage2_capacity")}))
        del state, outs
    for pods in MESH_GRID[1:]:
        require_invariant(views[MESH_GRID[0]], views[pods],
                          f"mesh2d (1,4) vs ({pods},{n // pods})")
    s, state, outs, ms = main
    ref_state, ref_outs, ref_ms = timed_periods(s, events, nows, "ref")
    require_states_equal(state, ref_state, "mesh2d kernels vs plain")
    err = runs_err(outs, ref_outs, "mesh2d kernels vs plain")
    del ref_state, ref_outs

    rs = system(2, crosspod_exchange="ragged")
    r_state, r_outs, r_ms = timed_periods(rs, events, nows)
    require(all(int(o.metrics["crosspod_sent"]) > 0 for o in r_outs),
            "[mesh2d] ragged: nothing crossed pods")
    require_invariant(views[2], view(rs, r_outs, r_state),
                      "mesh2d ragged vs padded",
                      metrics=list(outs[0].metrics))
    xpod = [(int(o.metrics["crosspod_sent"]),
             int(o.metrics["crosspod_messages"])) for o in r_outs]
    del r_state, r_outs

    hs = system(2, flow_home="rendezvous")
    h_state, h_outs, h_ms = timed_periods(hs, events, nows)
    require_accounting(h_outs, "mesh2d rendezvous", drops_allowed=False)
    hr_state, hr_outs, _ = timed_periods(hs, events, nows, "ref")
    require_states_equal(h_state, hr_state, "mesh2d rendezvous kernels vs "
                                            "plain")
    h_err = runs_err(h_outs, hr_outs, "mesh2d rendezvous kernels vs plain")
    del h_state, h_outs, hr_state, hr_outs

    seq = s.stream(s.init_state(), events, nows)
    ovl = s.stream(s.init_state(), events, nows, overlapped=True)
    require_states_equal(seq.state, ovl.state, "mesh2d overlapped")
    for f in ("enriched", "flow_ids", "mask"):
        a, b = getattr(seq, f), getattr(ovl, f)
        if f == "enriched":
            a, b = a.view(torch.int32), b.view(torch.int32)
        require(torch.equal(a, b), f"[mesh2d] overlapped {f} differs")
    for k in seq.metrics:
        require(torch.equal(seq.metrics[k], ovl.metrics[k]),
                f"[mesh2d] overlapped metric {k} differs")
    del seq, ovl

    prof = profile_periods(s.dfa_step, s.init_state(), events, nows,
                           "mesh2d")
    nonfinite = sum(int((~torch.isfinite(o.enriched)).sum()) for o in outs)
    log(f"[mesh2d] (2,2) PAPER V2 hash, metrics per period "
        f"{[{k: int(v) for k, v in o.metrics.items()} for o in outs]}")
    log(f"[mesh2d] (2,2) per-period ms (kernels): {[round(x, 3) for x in ms]}"
        f", mean after the first {np.mean(ms[1:]):.4f}; plain "
        f"{[round(x, 3) for x in ref_ms]}; ragged "
        f"{[round(x, 3) for x in r_ms]}; rendezvous "
        f"{[round(x, 3) for x in h_ms]}; launches {launches} "
        f"({ {k: v / MESH_PERIODS for k, v in launches.items()} } per "
        f"period); device idle {100 * prof['idle_share']:.1f} % "
        f"({prof['kernels']:.0f} device kernels per period)")
    log(f"[mesh2d] pod-count invariance (1,4) == (2,2) == (4,1) with the "
        f"kernels: merged state, flow-sorted outputs and metrics bit for "
        f"bit; (2,2) kernels == plain (state bitwise, features row-scaled "
        f"err {err:.3e}); ragged == padded bit for bit (crosspod sent, "
        f"messages per period {xpod}); rendezvous kernels == plain (err "
        f"{h_err:.3e}); overlapped == sequential bit for bit; non-finite "
        f"features {nonfinite}")
    return launches, events, nows


# -- phases 12-13: the serving loop on the (2,2) mesh; elastic pod loss and join

SERVE_MESH_PERIODS = 40              # [serving mesh] main run
SERVE_MESH_COMPARE = 8               # kernels vs plain serving periods
ELASTIC_NODES = (0, 3, 5, 9)         # the (2,2) rendezvous roster
ELASTIC_JOIN = (12, 17)              # the node ids of the pod that joins
ELASTIC_SNAPSHOT_EVERY = 4
ELASTIC_KILL_AT = 6                  # pod 1 declared dead after period 6
ELASTIC_DEAD_POD = 1
ELASTIC_PERIODS = 12
JOIN_PERIODS = 2


def serving_mesh_cfg(**changes):
    """[mesh2d]'s configuration under HRW homes over ELASTIC_NODES, served
    at line rate per port (2^20 events per port per 20 ms period, batches
    of 2^22), no host queue; collisions on a re-home warn."""
    return mesh2d_cfg(2, **{**dict(
        flow_home="rendezvous", home_nodes=ELASTIC_NODES,
        rehome_collision_policy="warn",
        serve_offered_eps=MESH_SHARDS * LINE_RATE_EPS,
        serve_budget_us=20_000, serve_queue_events=0), **changes})


def mesh_loop(system, host_ev, nows, **kw):
    from repro_torch.launch.serving import ServingLoop, build_source
    return ServingLoop(system, build_source(
        system, host_ev, nows, batch_events=MESH_SHARDS * EVENTS), **kw)


def captured(system):
    """Make ``system.dfa_step`` keep every period's outputs in the returned
    list (a serving run's outputs, to compare period by period)."""
    outs, step = [], system.dfa_step

    def keep(*a, **kw):
        out = step(*a, **kw)
        outs.append(out)
        return out

    system.dfa_step = keep
    return outs


def clone_state(state):
    return type(state)(*(type(g)(*(x.clone() for x in g)) for g in state))


def serving_mesh_phase(dev, host_ev, nows):
    """[serving mesh] ``ServingLoop`` on the PAPER V2 (2,2) mesh (see
    ``serving_mesh_cfg``): SERVE_MESH_PERIODS periods of the [mesh2d] trace
    replayed at line rate, snapshots off, launches from 0; p50/p99/p999 and
    violations against 20,000 us, the host split, the accounting
    (balanced, nothing dropped); a 2-period profile; SERVE_MESH_COMPARE
    periods with the kernels against as many with the plain versions (end
    state bit for bit, every period's outputs by ``compare_outputs``).
    Returns launches."""
    import torch
    from repro_torch.core.pipeline import DFASystem

    n = MESH_SHARDS

    def system(**changes):
        return DFASystem(serving_mesh_cfg(**changes), device=dev, n_shards=n)

    s = system()
    mesh_loop(s, host_ev, nows).run(2)           # warm-up, outside the counts
    torch.cuda.synchronize()
    for k in all_kernels():
        k.reset_counts()
    t0 = time.perf_counter()
    rep = mesh_loop(s, host_ev, nows).run(SERVE_MESH_PERIODS)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in path_kernels()}
    for name, c in launches.items():
        require(c >= n * SERVE_MESH_PERIODS, f"[serving mesh] {name} launched "
                f"{c} times in {SERVE_MESH_PERIODS} periods on {n} devices")
    want = SERVE_MESH_PERIODS * n * EVENTS
    require(rep.balanced and rep.dropped == 0 and rep.offered == want
            and rep.processed == want,
            f"[serving mesh] accounting: offered {rep.offered}, processed "
            f"{rep.processed}, dropped {rep.dropped}")
    lat = rep.latency
    split = {k: (float(np.mean(v)), float(np.percentile(v, 50)),
                 float(np.percentile(v, 99)))
             for k, v in rep.host_us.items()}
    m = {k: v.cpu().numpy() for k, v in rep.metrics.items()}
    log(f"[serving mesh] PAPER V2 (2,2) rendezvous over {ELASTIC_NODES}, "
        f"{SERVE_MESH_PERIODS} periods of {n} x {EVENTS} events offered at "
        f"{n * LINE_RATE_EPS:.0f} events/s, budget {rep.budget_us} us: p50 "
        f"{lat['p50']:.1f} us, p99 {lat['p99']:.1f} us, p999 "
        f"{lat['p999']:.1f} us (count {lat['count']}); SLO violations "
        f"{rep.violations} of {lat['count']}; sustained "
        f"{rep.sustained_eps:.0f} events/s; offered {rep.offered} == "
        f"processed {rep.processed} + dropped {rep.dropped}; wall "
        f"{wall:.3f} s; launches {launches} "
        f"({ {k: v / SERVE_MESH_PERIODS for k, v in launches.items()} } per "
        f"period)")
    log("[serving mesh] host us per period (mean, p50, p99): " + ", ".join(
        f"{k} {a:.1f} / {b:.1f} / {c:.1f}" for k, (a, b, c) in split.items()))
    log(f"[serving mesh] reports sent/recv per period (runs): "
        f"{runs_of(m['reports_sent'].tolist())} / "
        f"{runs_of(m['reports_recv'].tolist())}; bucket drops "
        f"{runs_of(m['bucket_drops'].tolist())}")

    def prof_run():
        lp, st = mesh_loop(s, host_ev, nows), s.init_state()
        lp.run(2, drain=False, state=st)
        return lambda k: lp.run(k, drain=False, state=st)

    p = serving_profile(prof_run(), 2)
    log(f"[serving mesh profile] per period of 2: wall {p['wall_us']:.1f} us, "
        f"device busy {p['busy_us']:.1f} us, idle {100 * p['idle_share']:.1f} "
        f"%, {p['kernels']:.1f} device kernels, cudaLaunchKernel "
        f"{p['cudaLaunchKernel']:.1f}, cudaStreamSynchronize "
        f"{p['cudaStreamSynchronize']:.1f}, cudaMemcpyAsync "
        f"{p['cudaMemcpyAsync']:.1f}")

    runs = {}
    for backend in ("auto", "ref"):
        sb = system(kernel_backend=backend)
        outs = captured(sb)
        runs[backend] = (mesh_loop(sb, host_ev, nows).run(SERVE_MESH_COMPARE),
                         outs)
    (a, ao), (b, bo) = runs["auto"], runs["ref"]
    require(len(ao) == len(bo) == SERVE_MESH_COMPARE,
            f"[serving mesh] compared {len(ao)} / {len(bo)} periods")
    require_states_equal(a.last.state, b.last.state,
                         "serving mesh kernels vs plain")
    err = runs_err(ao, bo, "serving mesh kernels vs plain")
    log(f"[serving mesh] {SERVE_MESH_COMPARE} periods, kernels vs plain: end "
        f"state bitwise, per-period metrics and routed flows equal, features "
        f"row-scaled err {err:.3e}; p50 {a.latency['p50']:.1f} vs "
        f"{b.latency['p50']:.1f} us")
    return launches


def elastic_phase(dev, host_ev, nows):
    """[elastic] The [serving mesh] system with a snapshot every
    ELASTIC_SNAPSHOT_EVERY periods (under build/): the chaos hook declares
    pod ELASTIC_DEAD_POD dead after period ELASTIC_KILL_AT and again two
    periods later; the loop recovers in place (restore, re-home, the
    journal's periods replayed) and serves to ELASTIC_PERIODS on the (1,2)
    survivor mesh, launches from 0. Live == offline
    (``recover_from_snapshot`` + the same batches through the survivor),
    the second declaration a counted no-op, and the same run with the plain
    versions gives the same final state, all bit for bit. Then
    ``join_system`` + ``expand_state`` grow the survivor back to (2,2) with
    ELASTIC_JOIN: JOIN_PERIODS periods with the kernels == with the plain
    versions. Returns launches."""
    import shutil
    import warnings

    import torch
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.launch import elastic as EL
    from repro_torch.launch.serving import build_source, host_tensors

    n = MESH_SHARDS
    snap_root = ROOT / "build" / "elastic_snapshots"

    def chaos(t):
        return ([ELASTIC_DEAD_POD] if t in (ELASTIC_KILL_AT,
                                            ELASTIC_KILL_AT + 2) else [])

    def recover_run(backend):
        d = snap_root / backend
        shutil.rmtree(d, ignore_errors=True)
        s = DFASystem(serving_mesh_cfg(
            kernel_backend=backend,
            snapshot_every_periods=ELASTIC_SNAPSHOT_EVERY), device=dev,
            n_shards=n)
        lp = mesh_loop(s, host_ev, nows, snapshot_dir=str(d), chaos=chaos)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            rep = lp.run(ELASTIC_PERIODS)
        return s, lp, rep, d, [str(w.message) for w in caught]

    for k in all_kernels():
        k.reset_counts()
    s, lp, rep, d, warned = recover_run("auto")
    launches = {k.name: k.launches for k in path_kernels()}
    for name, c in launches.items():
        require(c >= ELASTIC_PERIODS, f"[elastic] {name} launched {c} times")
    replay = ELASTIC_KILL_AT - ELASTIC_SNAPSHOT_EVERY
    surv = lp.system
    stats, parts = surv.last_rehome_stats, rep.recovery_us[0]
    require(rep.recoveries == 1 and rep.duplicate_recovery_skips == 1
            and rep.journal_replayed == replay and rep.balanced
            and len(rep.latency_us) == ELASTIC_PERIODS,
            f"[elastic] recoveries {rep.recoveries}, duplicate skips "
            f"{rep.duplicate_recovery_skips}, journal replayed "
            f"{rep.journal_replayed}, balanced {rep.balanced}")
    require(surv.home_nodes == ELASTIC_NODES[:2] and surv.n_shards == 2
            and surv.total_ports == n,
            f"[elastic] survivor {surv.describe()}")

    # offline: the same snapshot, recover_from_snapshot, then the same
    # batches from an identically built source through the survivor
    new, state, period = EL.recover_from_snapshot(
        s, str(d), ELASTIC_DEAD_POD, step=ELASTIC_SNAPSHOT_EVERY)
    require(period == ELASTIC_SNAPSHOT_EVERY
            and tuple(new.last_rehome_stats) == tuple(stats),
            f"[elastic] offline restored period {period}, stats "
            f"{new.last_rehome_stats} vs live {stats}")
    src = build_source(s, host_ev, nows, batch_events=n * EVENTS)
    for t in range(ELASTIC_PERIODS):
        b, now, _ = src.next_batch()
        if t >= period:
            ev, dn = host_tensors(b, now)
            state = new.dfa_step(state, {k: v.to(dev) for k, v in ev.items()},
                                 dn.to(dev)).state
    require_states_equal(rep.last.state, state, "elastic live vs offline")
    del state, new

    _, _, plain, d_ref, _ = recover_run("ref")
    require(plain.recoveries == 1 and plain.journal_replayed == replay,
            "[elastic] plain run did not recover as the kernel run did")
    require_states_equal(rep.last.state, plain.last.state,
                         "elastic kernels vs plain")
    del plain
    shutil.rmtree(d_ref, ignore_errors=True)
    log(f"[elastic] PAPER V2 (2,2) rendezvous over {ELASTIC_NODES}, snapshot "
        f"every {ELASTIC_SNAPSHOT_EVERY}, pod {ELASTIC_DEAD_POD} declared dead "
        f"after periods {ELASTIC_KILL_AT} and {ELASTIC_KILL_AT + 2}: "
        f"recoveries {rep.recoveries}, duplicate skips "
        f"{rep.duplicate_recovery_skips}, journal periods replayed "
        f"{rep.journal_replayed}; stall {rep.recovery_stall_us[0]:.1f} us = "
        f"restore {parts['restore']:.1f} + re-home {parts['rehome']:.1f} + "
        f"replay {parts['replay']:.1f} us (+ re-stage and bookkeeping); "
        f"moved rows {stats.moved_rows}, unsplittable {stats.unsplittable_collisions} "
        f"({len(warned)} warning(s)); survivor {surv.home_nodes}, "
        f"{surv.n_shards} shards, {surv.total_ports} ports; periods served "
        f"{len(rep.latency_us)}, p50 {rep.latency['p50']:.1f} us; launches "
        f"{launches}")
    log("[elastic] live == offline (recover_from_snapshot + the same batches "
        "through the survivor) bit for bit; the second declaration a counted "
        "no-op; kernels == plain after the recovery, bit for bit")

    # join: the survivor grows back to (2,2) with new node ids
    big = EL.join_system(surv, ELASTIC_JOIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grown, jstats = EL.expand_state(rep.last.state, surv, big)
    torch.cuda.synchronize()
    expand_ms = (time.perf_counter() - t0) * 1e3
    require(jstats.moved_rows > 0 and big.home_nodes == ELASTIC_NODES[:2]
            + ELASTIC_JOIN, f"[elastic] join: {jstats}, {big.home_nodes}")
    batches = [host_tensors(*lp.source.next_batch()[:2])
               for _ in range(JOIN_PERIODS)]
    joined = {}
    for backend in ("auto", "ref"):
        st, outs = clone_state(grown), []
        for ev, dn in batches:
            out = big.dfa_step(st, {k: v.to(dev) for k, v in ev.items()},
                               dn.to(dev), backend=backend)
            st = out.state
            outs.append(out)
        joined[backend] = (st, outs)
    require_states_equal(joined["auto"][0], joined["ref"][0],
                         "elastic join kernels vs plain")
    err = runs_err(joined["auto"][1], joined["ref"][1],
                   "elastic join kernels vs plain")
    require_accounting(joined["auto"][1], "elastic join", drops_allowed=False)
    log(f"[elastic] join {ELASTIC_JOIN}: (1,2) -> (2,2) roster "
        f"{big.home_nodes}; expand_state {expand_ms:.3f} ms, moved rows "
        f"{jstats.moved_rows} of {jstats.scanned_rows} scanned, unsplittable "
        f"{jstats.unsplittable_collisions}; {JOIN_PERIODS} periods kernels == "
        f"plain (state bitwise, features row-scaled err {err:.3e})")
    shutil.rmtree(snap_root, ignore_errors=True)
    return launches


# -- phase 14: goldens ---------------------------------------------------------

def check_golden(path: Path, out, extra=None):
    """One run's outputs against a golden fingerprint: every pinned field
    (integers exactly, float summaries to 1e-4, ``ring_checksum`` when
    pinned), as tests/test_run_periods_golden.py checks them."""
    from repro_torch.convert import state_to_numpy

    want = json.loads(path.read_text())
    tag = f"golden {path.name}"
    st = state_to_numpy(out.state)
    enr, fid = out.enriched.cpu().numpy(), out.flow_ids.cpu().numpy()
    em = out.mask.cpu().numpy()
    for k, v in (extra or {}).items():
        require(want.get(k) == v, f"{tag}: {k} {v} != {want.get(k)}")
    require(int(st.collector.received.astype(np.uint64).sum())
            == want["collector_received"], f"{tag}: collector_received")
    require(int(st.collector.entry_valid.sum()) == want["entry_valid_count"],
            f"{tag}: entry_valid_count")
    require(int(np.bitwise_xor.reduce(st.reporter.regs.reshape(-1)))
            == want["regs_checksum"], f"{tag}: regs_checksum")
    if "ring_checksum" in want:
        require(int(np.bitwise_xor.reduce(st.collector.memory.reshape(-1)))
                == want["ring_checksum"], f"{tag}: ring_checksum")
    for t, w in enumerate(want["periods"]):
        rows = em[t]
        e = enr[t][rows].astype(np.float64)
        require(int(rows.sum()) == w["received"], f"{tag} {t}: received")
        require(sorted(int(x) for x in fid[t][rows]) == w["flow_ids"],
                f"{tag} {t}: flow_ids")
        for k, v in w["metrics"].items():
            require(int(out.metrics[k][t]) == v, f"{tag} {t}: {k}")
        for k in set(out.metrics) - set(w["metrics"]):
            require(int(out.metrics[k][t]) == 0, f"{tag} {t}: {k} not 0")
        np.testing.assert_allclose(e.sum(), w["enriched_sum"], rtol=1e-4)
        np.testing.assert_allclose(np.abs(e).mean(), w["enriched_abs_mean"],
                                   rtol=1e-4)
        np.testing.assert_allclose(np.sort(e, axis=0)[0][:8],
                                   w["first_row_head"], rtol=1e-4, atol=1e-6)
    return want


def golden(dev):
    """The single-shard golden (REDUCED, T=4) and both multipod goldens
    (REDUCED_MULTIPOD and REDUCED_MULTIPOD_V2 on a (2,2) mesh over the
    port's own cross_pod_mix scenario), with the kernels."""
    import torch
    from repro_torch import u32 as U
    from repro_torch.configs import (REDUCED, REDUCED_MULTIPOD,
                                     REDUCED_MULTIPOD_V2)
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK
    from repro_torch.data import scenarios as SC

    want = json.loads(GOLDEN.read_text())
    system = DFASystem(REDUCED, device=dev)
    events, nows = PK.period_batches(1, want["T"], want["events_per_shard"],
                                     n_flows=10, flow_seed=3, device=dev)
    check_golden(GOLDEN, system.run_periods(system.init_state(), events,
                                            nows))
    log(f"[golden] REDUCED T={want['T']} reproduces "
        f"{GOLDEN.relative_to(ROOT)}")
    for name, cfg, wire in (
            ("run_periods_multipod_t4", REDUCED_MULTIPOD, None),
            ("run_periods_multipod_v2_t4", dataclasses.replace(
                REDUCED_MULTIPOD_V2, port_report_capacity=32), "v2")):
        path = GOLDEN.parent / f"{name}.json"
        T = json.loads(path.read_text())["T"]
        system = DFASystem(cfg, device=dev, n_shards=4)
        ev, now = SC.build("cross_pod_mix", system.total_ports,
                           want["events_per_shard"] // system.total_ports, T,
                           seed=3)
        events = {k: (torch.from_numpy(v).to(dev) if k == "valid"
                      else U.from_numpy(v, dev)) for k, v in ev.items()}
        nows = torch.from_numpy(now.astype(np.int64)).to(dev)
        for k in path_kernels():
            k.reset_counts()
        out = system.run_periods(system.init_state(), events, nows)
        for k in path_kernels():
            require(k.launches >= T, f"[golden] {name}: {k.name} launched "
                                     f"{k.launches} times")
        extra = {"mesh": [2, 2], "total_ports": 4, "flow_home": "hash"}
        if wire:
            extra["wire_format"] = wire
        check_golden(path, out, extra)
        log(f"[golden] REDUCED_MULTIPOD{'_V2' if wire else ''} on (2,2), "
            f"T={T}, kernels: reproduces {path.relative_to(ROOT)}"
            f"{' (ring_checksum included)' if wire else ''}")


# -- phase 15: serving at full width -------------------------------------------

def attention_blocks(cfg) -> int:
    """Attention calls of one forward: one per layer, for the hybrid
    family one per segment (its shared blocks), for the encdec family one
    per encoder and one per decoder layer (cross attention is plain), and
    none for the ssm family."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import _plan
        return _plan(cfg)[0]
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.encdec.num_encoder_layers + cfg.num_layers
    return cfg.num_layers


def blocks_by_kind(cfg) -> dict:
    """:func:`attention_blocks` by mask: {"causal": n, "full": n}; only
    the encdec family's encoder attends without a mask."""
    full = cfg.encdec.num_encoder_layers if cfg.family == "encdec" else 0
    return {"causal": attention_blocks(cfg) - full, "full": full}


def prefix_len(batch) -> int:
    """The positions a batch puts before its tokens: the vlm family's
    patches."""
    return batch["patches"].shape[1] if "patches" in batch else 0


def generate(model, params, tokens, gen_steps, forced=None, extra=None,
             cache_len=None):
    """Prefill ``tokens`` (B, P) (with ``extra``, e.g. whisper's frames or
    llava's patches, in the batch), then ``gen_steps - 1`` decode steps into
    a ``cache_len``-row cache (default SERVE_CACHE), the first at position
    P after any patch prefix: greedy, or fed the tokens of ``forced``
    (B, gen_steps). Returns (tokens (B, gen_steps), [prefill logits, then
    each decode step's logits] in f32)."""
    import torch
    from repro_torch.launch.serve import build_cache

    B, P = tokens.shape
    batch = {"tokens": tokens, **(extra or {})}
    logits, pcache = model.prefill(params, batch)
    cache = build_cache(model, pcache, B, cache_len or SERVE_CACHE)
    del pcache
    pos = torch.full((B,), prefix_len(batch) + P, dtype=torch.int64,
                     device=tokens.device)
    out, seen = [], [logits.float()]
    for i in range(gen_steps):
        tok = (logits.argmax(-1)[:, None] if forced is None
               else forced[:, i:i + 1])
        out.append(tok)
        if i == gen_steps - 1:
            break
        logits, cache = model.decode(params, tok, pos, cache)
        seen.append(logits.float())
        pos = pos + 1
    return torch.cat(out, 1), seen


def divergence(model, plain, m32, params, params32, tokens):
    """Where bf16 runs part: the residual stream after each layer of the
    prefill, bf16 kernel run and bf16 plain run each against the f32
    kernel run, as max |dx| over max |x| (printed, not held)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM

    runs = [(model, params), (plain, params), (m32, params32)]
    xs = [L.embed(p["embed"], tokens) for _, p in runs]
    rows = []
    layers = [LM.layers(p, model.cfg) for _, p in runs]
    for layer in range(model.cfg.num_layers):
        for i, (m, _) in enumerate(runs):
            kind, lp = layers[i][layer]
            xs[i], _ = LM.block_prefill(lp, xs[i], m.cfg, backend=m.backend,
                                        kind=kind)
        ref = xs[2].float()
        scale = float(ref.abs().max())
        rows.append((float((xs[0].float() - ref).abs().max()) / scale,
                     float((xs[1].float() - ref).abs().max()) / scale))
    pick = sorted({i for i in (0, 1, 2, 4, 9, 19) if i < len(rows)}
                  | {len(rows) - 1})
    log("[serve] residual stream vs f32 after layer (bf16 kernel, bf16 "
        "plain): " + ", ".join(f"{i}: ({rows[i][0]:.2e}, {rows[i][1]:.2e})"
                               for i in pick))
    del xs
    torch.cuda.empty_cache()


def logit_ratio(got, want) -> float:
    """max |got - want| over max |want|, the worst over matching lists."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


def wgmma_per_layer(model, params, prompt):
    """Each layer's attention inside one bf16 prefill, run again on the
    wgmma kernel and on the SIMT kernel (``force_variant="simt"``) with
    the same bf16 q, k, v: max |o_wgmma - o_simt| / max |o_simt| per
    layer, held to the per-call tests' 2e-2."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models import attention as A

    captured = []
    original = A.flash_attention

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw["group"]))
        return original(q, k, v, **kw)
    A.flash_attention = capture
    try:
        model.prefill(params, {"tokens": prompt})
    finally:
        A.flash_attention = original
    require(len(captured) == model.cfg.num_layers,
            f"[serve] captured {len(captured)} attention calls of a "
            f"{model.cfg.num_layers}-layer prefill")
    ratios = []
    for q, k, v, g in captured:
        require(K.variant(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma",
                "[serve] a bf16 prefill layer is not a wgmma shape")
        w = K.flash_attention_cuda(q, k, v, group=g)
        s = K.flash_attention_cuda(q, k, v, group=g, force_variant="simt")
        ratios.append(float((w.float() - s.float()).abs().max())
                      / float(s.float().abs().max()))
    del captured
    tol = ATT_TOL["bfloat16"]
    log(f"[serve] wgmma vs simt K6 per layer of a bf16 prefill, max |do| / "
        f"max |o|: {[float(f'{r:.3e}') for r in ratios]}; worst "
        f"{max(ratios):.3e} at layer {int(np.argmax(ratios))} (held: <= "
        f"{tol:g})")
    require(max(ratios) <= tol, "[serve] the wgmma kernel disagrees with "
                                "the SIMT kernel inside the prefill")
    return ratios


def upcast(params):
    """A copy of a parameter tree in f32."""
    return {k: upcast(v) if isinstance(v, dict) else v.float()
            for k, v in params.items()}


def hidden_fn(cfg):
    """The full forward to the final hidden states of ``cfg``'s family:
    (params, batch, cfg) -> (B, S, d)."""
    from repro_torch.models import hybrid as HY
    from repro_torch.models import lm as LM
    from repro_torch.models import rwkv_lm as RW
    from repro_torch.models import whisper as WH
    return {"hybrid": HY.hybrid_hidden, "ssm": RW.rwkv_hidden,
            "encdec": WH.whisper_hidden}.get(cfg.family, LM.lm_hidden)


def logit_checks(tag, cfg, params, prompt, note_b="", extra=None,
                 cache_len=None):
    """Checks (a)-(c) of a bf16 model ``cfg`` with ``params`` on one token
    stream, the f32 kernel run's greedy tokens from ``prompt`` (with
    ``extra`` in the batch, e.g. whisper's frames, which the f32 runs get
    in f32), all measured and printed here and held by
    :func:`require_logit_checks`: (a) the f32 model, kernel run against
    plain run, prefill and teacher-forced decode logits; (b) bf16, each
    run's distance to the f32 kernel run; (c) the f32 decode step at
    position P against a full forward over P + 1 tokens (for the hybrid
    family it carries the Mamba2 and conv states across the prefill). The
    f32 prefill must run K6's simt variant once per attention block.
    SERVE_GEN greedy tokens into ``cache_len`` rows; with llava's patches
    in ``extra`` the decode positions and (c)'s forward count them."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.models import layers as L
    from repro_torch.models.registry import Model

    dev = prompt.device
    model = Model(cfg, device=dev)
    plain = Model(cfg, device=dev, backend="ref")
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = upcast(params)
    m32, p32 = Model(cfg32, device=dev), Model(cfg32, device=dev,
                                               backend="ref")
    P = prompt.shape[1]
    gen = SERVE_GEN
    extra = extra or {}
    extra32 = {n: t.float() for n, t in extra.items()}
    run = dict(cache_len=cache_len)
    counts = dict(K6.launches_by_variant)
    toks32, lg32 = generate(m32, params32, prompt, gen, extra=extra32, **run)
    require(K6.launches_by_variant == {**counts, "simt": counts["simt"]
                                       + attention_blocks(cfg)},
            f"{tag} the f32 prefill did not run flash_attention's simt "
            "variant once per attention block")
    _, lg32_ref = generate(p32, params32, prompt, gen, forced=toks32,
                           extra=extra32, **run)
    _, lgb = generate(model, params, prompt, gen, forced=toks32,
                      extra=extra, **run)
    _, lgb_ref = generate(plain, params, prompt, gen, forced=toks32,
                          extra=extra, **run)
    h = hidden_fn(cfg)(params32, {
        "tokens": torch.cat([prompt, toks32[:, :1]], 1), **extra32}, cfg32)
    fwd = L.logits_fn(params32["embed"], h[:, -1:],
                      cfg.tie_embeddings)[:, 0].float()
    r = {"a": (logit_ratio(lg32[:1], lg32_ref[:1]),
               logit_ratio(lg32[1:], lg32_ref[1:])),
         "b": (logit_ratio(lgb[:1], lgb_ref[:1]),
               logit_ratio(lgb[1:], lgb_ref[1:])),
         "err_k": logit_ratio(lgb, lg32), "err_p": logit_ratio(lgb_ref, lg32),
         "c": logit_ratio(lg32[1:2], [fwd]),
         "model": model, "plain": plain, "m32": m32, "params32": params32}
    log(f"{tag} (a) f32 kernel vs plain: max |dlogit| / max |logit| "
        f"prefill {r['a'][0]:.3e}, teacher-forced decode over "
        f"{gen - 1} steps {r['a'][1]:.3e} (tolerance {A_TOL:g})")
    log(f"{tag} (b) bf16 kernel vs plain: prefill {r['b'][0]:.3e}, decode "
        f"{r['b'][1]:.3e}; each bf16 run against the f32 run: kernel "
        f"{r['err_k']:.3e}, plain {r['err_p']:.3e} (held: kernel <= "
        f"{B_RATIO:g} x plain){note_b}")
    n = prefix_len(extra) + P
    log(f"{tag} (c) decode logits at position {n} vs a full forward over "
        f"{n + 1} positions (f32): {r['c']:.3e} (tolerance {A_TOL:g})")
    return r


def require_logit_checks(tag, r) -> None:
    require(max(r["a"]) <= A_TOL, f"{tag} (a) f32 kernel run and plain run "
                                  "disagree")
    require(r["err_k"] <= B_RATIO * r["err_p"],
            f"{tag} (b) the bf16 kernel run is further from the f32 run "
            "than the bf16 plain run is")
    require(r["c"] <= A_TOL, f"{tag} (c) decode disagrees with the forward")


def request_batch(cfg, tokens, i: int):
    """Request ``i``'s batch: its tokens and, for the encdec and vlm
    families, the stub frames or patches ``data.tokens.add_modality_stub``
    draws for step ``i``."""
    from repro_torch.data import tokens as DATA
    return DATA.add_modality_stub({"tokens": tokens}, cfg, i)


def serve_requests(tag, cfg, dev, n_timed: int, variant,
                   prompt_len=SERVE_PROMPT, cache_len=SERVE_CACHE):
    """``cfg``'s model on the card with seeded random weights: one warm-up
    request and ``n_timed`` timed ones of SERVE_B x ``prompt_len``-token
    prompts (for the encdec and vlm families with the stub frames or
    patches of :func:`request_batch`; decoding starts after the patches)
    and SERVE_GEN greedy tokens into ``cache_len`` rows,
    launch counts from 0 before the timed ones, each prefill required to
    launch flash_attention once per attention block
    (:func:`attention_blocks`), by mask as :func:`blocks_by_kind` says,
    all on ``variant`` (None for a model without attention). Returns
    (model, params, prompts, runs, launches over the timed requests,
    flash_attention's by variant)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.launch.serve import serve
    from repro_torch.models.param import count_params
    from repro_torch.models.registry import Model

    P, G, C = prompt_len, SERVE_GEN, cache_len
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}: {count_params(model.param_descs())} parameters "
        f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, {cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (SERVE_B, P),
                             generator=gen, device=dev)
               for _ in range(n_timed + 1)]
    n_prefix = cfg.vision.num_patches if cfg.family == "vlm" else 0
    args = (n_prefix + P, G, C)

    serve(model, params, request_batch(cfg, prompts[0], 0), *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    variant_count = lambda: K6.launches_by_variant[variant] if variant else 0
    runs = []
    for i, prompt in enumerate(prompts[1:], 1):
        batch = request_batch(cfg, prompt, i)
        before, stats = K6.launches, {}
        on_variant = variant_count()
        kinds = dict(K6.launches_by_kind)
        toks, tps = serve(model, params, batch, *args, stats=stats)
        runs.append((toks, tps, stats, K6.launches - before,
                     variant_count() - on_variant,
                     {n: K6.launches_by_kind[n] - kinds[n] for n in kinds}))
    launches = {k.name: k.launches for k in kernels}
    variants = dict(K6.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    for _, _, _, n, n_on, by_kind in runs:
        require(n == attention_blocks(cfg),
                f"{tag} a request launched flash_attention {n} times, "
                f"expected {attention_blocks(cfg)} (one per attention "
                f"block)")
        require(by_kind == blocks_by_kind(cfg),
                f"{tag} a request launched flash_attention {by_kind} by "
                f"mask, expected {blocks_by_kind(cfg)}")
        require(variant is None or n_on == n,
                f"{tag} {n - n_on} of a bf16 prefill's {n} "
                           f"flash_attention launches were not on the "
                           f"{variant} variant")
    prefill_ms = [r[2]["prefill_s"] * 1e3 for r in runs]
    step_ms = [r[2]["decode_s"] * 1e3 / (G - 1) for r in runs]
    total_s = [r[2]["prefill_s"] + r[2]["decode_s"] for r in runs]
    log(f"{tag} {len(runs)} timed requests of B={SERVE_B} x "
        f"{f'{n_prefix} patches + ' if n_prefix else ''}"
        f"{P}-token prompts, {G} greedy tokens, cache "
        f"{C}: prefill ms {[round(x, 3) for x in prefill_ms]}, "
        f"decode ms/step {[round(x, 4) for x in step_ms]}")
    rate = f"{SERVE_B * P / np.mean(prefill_ms) * 1e3:.1f} prefill tok/s"
    if n_prefix:
        rate += (f", {SERVE_B * (n_prefix + P) / np.mean(prefill_ms) * 1e3:.1f}"
                 " positions/s with the patches")
    log(f"{tag} mean prefill {np.mean(prefill_ms):.3f} ms ({rate}), decode "
        f"{np.mean(step_ms):.4f} ms/step, generated "
        f"{np.mean([r[1] for r in runs]):.2f} tok/s "
        f"({SERVE_B * G / np.mean(total_s):.2f} from the mean "
        f"request); max_memory_allocated {peak} B; flash_attention launches "
        f"per request {[r[3] for r in runs]} ({variant} "
        f"{[r[4] for r in runs]}; by mask {[r[5] for r in runs]}); "
        f"launches {launches}")
    for toks, *_ in runs:
        require(toks.shape == (SERVE_B, G)
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
                f"{tag} generated tokens out of range")
    return model, params, prompts, runs, launches, variants


def serve_phase(dev):
    """granite-3-2b serving at full width (see the module docstring);
    returns the kernels' launch counts over the 3 timed requests, and
    flash_attention's by variant."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import Model

    cfg = get_config("granite-3-2b")
    model, params, prompts, runs, launches, variants = serve_requests(
        "[serve]", cfg, dev, 3, "wgmma")
    plain = Model(cfg, device=dev, backend="ref")
    args = (SERVE_PROMPT, SERVE_GEN, SERVE_CACHE)

    profile_window("serve", lambda: serve(model, params,
                                          {"tokens": prompts[1]}, *args), 1)

    before, stats = K6.launches, {}
    plain_toks, _ = serve(plain, params, {"tokens": prompts[1]}, *args,
                          stats=stats)
    require(K6.launches == before, "[serve] the plain run launched "
                                   "flash_attention")
    log(f"[serve] plain run (backend='ref'): prefill "
        f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
        f"{stats['decode_s'] * 1e3 / (SERVE_GEN - 1):.4f} ms/step, 0 "
        f"flash_attention launches")

    wgmma_per_layer(model, params, prompts[1])

    agree = int((plain_toks == runs[0][0]).sum())
    r = logit_checks("[serve]", cfg, params, prompts[1],
                     f"; greedy tokens of the two free bf16 runs that agree "
                     f"{agree} of {plain_toks.numel()}")
    divergence(r["model"], r["plain"], r["m32"], params, r["params32"],
               prompts[1])
    require_logit_checks("[serve]", r)
    return launches, variants


# -- phases 16-18: deepseek-v3 (MLA, MoE), qwen3-14b and zamba2-2.7b serving ---

def moe_drops(run):
    """The share of (token, expert) pairs dropped by capacity in each MoE
    layer that ``run()`` (a prefill, or a loss under no_grad) goes
    through (``models.moe.drops_of``)."""
    from repro_torch.models import moe as M
    return [dropped / pairs for dropped, pairs in M.drops_of(run)]


def serve_arch_phase(dev, tag, cfg, variant, check_cfg):
    """``cfg`` served at full width as :func:`serve_requests` does, with 2
    timed requests; for the moe family the share of pairs each MoE layer
    drops; the gap of the bf16 plain run (backend="ref") to the kernel run
    on the same weights and the kernel run's greedy tokens (printed); then,
    with those weights freed, checks (a)-(c) on ``check_cfg`` (a cut that
    fits in f32 beside its bf16 copy) with fresh seeded weights. Returns
    the launch counts over the timed requests, and flash_attention's by
    variant."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.models.registry import Model

    model, params, prompts, runs, launches, variants = serve_requests(
        tag, cfg, dev, 2, variant)
    if cfg.moe:
        from repro_torch.models import moe as M
        shares = moe_drops(lambda: model.prefill(params,
                                                 {"tokens": prompts[1]}))
        log(f"{tag} pairs dropped by capacity (C = "
            f"{M.capacity(cfg, SERVE_B * SERVE_PROMPT)} per expert over "
            f"{SERVE_B * SERVE_PROMPT} tokens x top-{cfg.moe.top_k}) per MoE "
            f"layer of a prefill: {[f'{x:.4%}' for x in shares]}; decode "
            f"runs at C = {M.capacity(cfg, SERVE_B)}")
    before = K6.launches
    toks, lg = generate(model, params, prompts[1], SERVE_GEN)
    _, lg_ref = generate(Model(cfg, device=dev, backend="ref"), params,
                         prompts[1], SERVE_GEN, forced=toks)
    require(K6.launches == before + attention_blocks(cfg),
            f"{tag} expected {attention_blocks(cfg)} flash_attention launches "
            "from the kernel run's prefill and none from the plain run")
    log(f"{tag} bf16 plain run vs kernel run on the kernel run's tokens: "
        f"max |dlogit| / max |logit| prefill "
        f"{logit_ratio(lg[:1], lg_ref[:1]):.3e}, teacher-forced decode "
        f"{logit_ratio(lg[1:], lg_ref[1:]):.3e}")
    del model, params, prompts, runs, lg, lg_ref
    torch.cuda.empty_cache()

    cparams = Model(check_cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(2))
    prompt = torch.randint(0, check_cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(3), device=dev)
    log(f"{tag} checks (a)-(c) on {check_cfg.num_layers} layers "
        f"({check_cfg.name}, seeded weights, bf16 and an f32 copy)")
    r = logit_checks(tag, check_cfg, cparams, prompt)
    require_logit_checks(tag, r)
    del cparams, r
    torch.cuda.empty_cache()
    return launches, variants


def serve_deepseek_phase(dev):
    """deepseek-v3 cut to 5 layers (3 dense + 2 MoE) with its MTP block
    left out; checks on the 3 dense layers (MLA + FFN): with MoE layers a
    decode step's C = 1 drops pairs that a full forward keeps (in the
    reference too), so (c) would not hold."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b").replace(num_layers=5, mtp_depth=0)
    return serve_arch_phase(dev, "[serve deepseek-v3]", cfg, "wgmma",
                            cfg.replace(num_layers=cfg.moe.first_moe_layer))


def serve_qwen_phase(dev):
    """qwen3-14b whole; checks on 8 of its layers."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-14b")
    return serve_arch_phase(dev, "[serve qwen3-14b]", cfg, "wgmma",
                            cfg.replace(num_layers=8))


def serve_zamba2_phase(dev):
    """zamba2-2.7b whole (54 Mamba2 layers in 9 segments, each closed by
    one of the 2 shared attention + FFN blocks): K6 once per segment on
    its SIMT kernel (head dim 80); checks on 12 layers (2 segments, both
    shared blocks)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-2.7b")
    return serve_arch_phase(dev, "[serve zamba2-2.7b]", cfg, "simt",
                            cfg.replace(num_layers=2 * cfg.hybrid.attn_every))


# -- rwkv6-3b (ssm) and whisper-tiny (encdec) serving --------------------------

RWKV_CHECK_LAYERS = 4
# the card against the CPU: B x P tokens, two chunks of 128
RWKV_CPU_B, RWKV_CPU_P = 2, 256
CPU_TOL = 1e-4     # f32 logits and state leaves, card vs CPU, of their max
# whisper's 448-token text context: 416-token prompts and 32 greedy tokens
WHISPER_PROMPT, WHISPER_CACHE = 416, 448


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, on the CPU in f32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def serve_rwkv_phase(dev):
    """rwkv6-3b whole (32 layers, d 2560, 40 heads of 64, vocabulary 65536;
    3,094,620,160 parameters, bf16) served as :func:`serve_requests` does,
    2 timed requests: no attention, so no K6 launch and no plain attention
    call; then :func:`rwkv_checks` on a 4-layer cut with fresh seeded
    weights. Returns the launch counts over the timed requests and
    flash_attention's by variant."""
    import torch
    from repro_torch.configs import get_config
    tag = "[serve rwkv6-3b]"
    cfg = get_config("rwkv6-3b")
    with PlainCalls() as plain:
        model, params, prompts, runs, launches, variants = serve_requests(
            tag, cfg, dev, 2, None)
    log(f"{tag} plain attention calls {plain.calls}")
    require(plain.calls == 0 and not any(launches.values()),
            f"{tag} the attention-free model launched {launches} and made "
            f"{plain.calls} plain attention calls")
    del model, params, prompts, runs
    torch.cuda.empty_cache()
    rwkv_checks(dev, tag, cfg.replace(num_layers=RWKV_CHECK_LAYERS))
    torch.cuda.empty_cache()
    return launches, variants


def rwkv_checks(dev, tag, cfg):
    """On ``cfg`` (rwkv6-3b cut to a few layers) with seeded weights: (i)
    the card's f32 prefill logits and every state leaf against the CPU's
    run of the same parameters (RWKV_CPU_B x RWKV_CPU_P tokens), within
    CPU_TOL of the largest element; (ii) bf16 on the same weights rounded:
    the card's logits no further from the CPU's f32 logits than the CPU's
    bf16 logits are, x B_RATIO; (iii) on the card in f32 at SERVE_B x
    SERVE_PROMPT, a prefill over P + 1 tokens (its chunk falls to 41)
    against a prefill over P (chunks of 128) plus one decode step: the
    logits within A_TOL of the largest logit and every state leaf within
    A_TOL of its largest element."""
    import torch
    from repro_torch.launch.serve import build_cache
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(2))
    params32 = upcast(params)
    tokens = torch.randint(0, cfg.vocab_size, (RWKV_CPU_B, RWKV_CPU_P),
                           generator=torch.Generator().manual_seed(3))
    cpu = torch.device("cpu")
    on_cpu = lambda tree: adamw.tree_map(lambda t: t.to(cpu), tree)
    runs = {}
    for name, c, p, d in (("card f32", cfg32, params32, dev),
                          ("cpu f32", cfg32, on_cpu(params32), cpu),
                          ("card bf16", cfg, params, dev),
                          ("cpu bf16", cfg, on_cpu(params), cpu)):
        t0 = time.perf_counter()
        with torch.no_grad():
            runs[name] = Model(c, device=d).prefill(p, {"tokens":
                                                        tokens.to(d)})
        if d.type == "cuda":
            torch.cuda.synchronize()
        log(f"{tag} {name} prefill of {RWKV_CPU_B} x {RWKV_CPU_P} tokens "
            f"on {cfg.num_layers} layers: {time.perf_counter() - t0:.2f} s")
    (lg, st), (lg_cpu, st_cpu) = runs["card f32"], runs["cpu f32"]
    errs = {"logits": rel_err(lg, lg_cpu),
            **{n: rel_err(st[n], st_cpu[n]) for n in st_cpu}}
    err_card = rel_err(runs["card bf16"][0], lg_cpu)
    err_cpu = rel_err(runs["cpu bf16"][0], lg_cpu)
    log(f"{tag} (i) card vs CPU in f32, of each leaf's max: "
        f"{ {n: f'{e:.3e}' for n, e in errs.items()} } (tolerance "
        f"{CPU_TOL:g})")
    log(f"{tag} (ii) bf16 logits against the CPU's f32: card {err_card:.3e}"
        f", CPU {err_cpu:.3e} (held: card <= {B_RATIO:g} x CPU)")
    require(max(errs.values()) <= CPU_TOL,
            f"{tag} (i) the card's f32 prefill differs from the CPU's")
    require(err_card <= B_RATIO * err_cpu,
            f"{tag} (ii) the card's bf16 logits are further from f32 than "
            "the CPU's bf16 logits are")
    del runs, params
    torch.cuda.empty_cache()

    m32 = Model(cfg32, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + 1),
                           generator=torch.Generator(device=dev)
                           .manual_seed(4), device=dev)
    with torch.no_grad():
        full, fstate = m32.prefill(params32, {"tokens": prompt})
        _, pcache = m32.prefill(params32, {"tokens": prompt[:, :-1]})
        cache = build_cache(m32, pcache, SERVE_B, SERVE_CACHE)
        pos = torch.full((SERVE_B,), SERVE_PROMPT, dtype=torch.int64,
                         device=dev)
        step, cache = m32.decode(params32, prompt[:, -1:], pos, cache)
    errs = {"logits": rel_err(step, full),
            **{n: rel_err(cache[n], fstate[n]) for n in fstate}}
    log(f"{tag} (iii) f32 prefill over {SERVE_PROMPT} tokens + one decode "
        f"step vs a prefill over {SERVE_PROMPT + 1}, of each leaf's max: "
        f"{ {n: f'{e:.3e}' for n, e in errs.items()} } (tolerance "
        f"{A_TOL:g})")
    require(max(errs.values()) <= A_TOL,
            f"{tag} (iii) the decode step disagrees with the prefill over "
            "P + 1 tokens")
    del params32, full, fstate, pcache, cache
    torch.cuda.empty_cache()


def serve_whisper_phase(dev):
    """whisper-tiny whole (4 encoder + 4 decoder layers, d 384, 6 heads of
    64, 1500 stub frames, vocabulary 51865; 58,528,512 parameters, bf16)
    served as :func:`serve_requests` does, B = SERVE_B, 416-token prompts
    and 32 greedy tokens into its 448-token text context, 2 timed
    requests: each prefill launches K6 4 times without a mask (the
    encoder) and 4 times causal (the decoder), all wgmma; no plain
    attention call; the encoder's time alone; then checks (a)-(c) on the
    whole model. Returns the launch counts over the timed requests,
    flash_attention's by variant and by mask."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.models import whisper as WH
    tag = "[serve whisper-tiny]"
    cfg = get_config("whisper-tiny")
    with PlainCalls() as plain:
        model, params, prompts, runs, launches, variants = serve_requests(
            tag, cfg, dev, 2, "wgmma", WHISPER_PROMPT, WHISPER_CACHE)
    kinds = dict(K6.launches_by_kind)
    require(plain.calls == 0, f"{tag} {plain.calls} plain attention calls")
    batch = request_batch(cfg, prompts[1], 1)
    with torch.no_grad():
        enc_ms = time_ms(lambda: WH.encode(params, batch["frames"], cfg), 5)
    log(f"{tag} the encoder alone over B={SERVE_B} x "
        f"{cfg.encdec.num_frames} frames: {enc_ms:.3f} ms; K6 launches by "
        f"mask over the timed requests {kinds}, by variant {variants}; "
        f"plain attention calls {plain.calls}")
    r = logit_checks(tag, cfg, params, prompts[1],
                     extra={"frames": batch["frames"]},
                     cache_len=WHISPER_CACHE)
    require_logit_checks(tag, r)
    del model, params, prompts, runs, r, batch
    torch.cuda.empty_cache()
    return launches, variants, kinds


# -- llava-next-mistral-7b (vlm) serving ----------------------------------------

LLAVA_CHECK_LAYERS = 4
# the decode cache: the 2880 patches, the 1024-token prompt, 32 tokens
LLAVA_CACHE = LLAVA_PATCHES + SERVE_PROMPT + SERVE_GEN


def serve_llava_phase(dev):
    """llava-next-mistral-7b whole (32 layers, d 4096, 32 / 8 heads of 128,
    untied 32,000-row vocabulary; 7,241,732,096 parameters, bf16) served as
    :func:`serve_requests` does, B = SERVE_B x (2880 stub patches + a
    1024-token prompt), 32 greedy tokens from position 3904, 2 timed
    requests: each prefill launches K6 32 times, causal, all wgmma, over
    3904 positions; no plain attention call; the bf16 plain run's logit
    gap to the kernel run on its tokens; then checks (a)-(c) on 4 of its
    layers with fresh seeded weights and the same prefix ((c) at position
    3904 against a forward over 3905 positions, the patches included).
    Returns the launch counts over the timed requests, flash_attention's
    by variant and by mask."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.models.registry import Model
    tag = "[serve llava-next-mistral-7b]"
    cfg = get_config("llava-next-mistral-7b")
    require(cfg.vision.num_patches == LLAVA_PATCHES,
            f"{tag} expected {LLAVA_PATCHES} stub patches")
    with PlainCalls() as plain:
        model, params, prompts, runs, launches, variants = serve_requests(
            tag, cfg, dev, 2, "wgmma", SERVE_PROMPT, LLAVA_CACHE)
    kinds = dict(K6.launches_by_kind)
    require(plain.calls == 0, f"{tag} {plain.calls} plain attention calls")
    extra = {"patches": request_batch(cfg, prompts[1], 1)["patches"]}
    before = K6.launches
    toks, lg = generate(model, params, prompts[1], SERVE_GEN, extra=extra,
                        cache_len=LLAVA_CACHE)
    _, lg_ref = generate(Model(cfg, device=dev, backend="ref"), params,
                         prompts[1], SERVE_GEN, forced=toks, extra=extra,
                         cache_len=LLAVA_CACHE)
    require(K6.launches == before + attention_blocks(cfg),
            f"{tag} expected {attention_blocks(cfg)} flash_attention launches "
            "from the kernel run's prefill and none from the plain run")
    log(f"{tag} K6 launches by mask over the timed requests {kinds}, by "
        f"variant {variants}; plain attention calls {plain.calls}; bf16 "
        f"plain run vs kernel run on the kernel run's tokens: max |dlogit| "
        f"/ max |logit| prefill {logit_ratio(lg[:1], lg_ref[:1]):.3e}, "
        f"teacher-forced decode {logit_ratio(lg[1:], lg_ref[1:]):.3e}")
    del model, params, prompts, runs, lg, lg_ref, extra
    torch.cuda.empty_cache()

    ccfg = cfg.replace(num_layers=LLAVA_CHECK_LAYERS)
    cparams = Model(ccfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(2))
    prompt = torch.randint(0, ccfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(3), device=dev)
    patches = request_batch(ccfg, prompt, 0)["patches"]
    log(f"{tag} checks (a)-(c) on {ccfg.num_layers} layers (seeded weights, "
        f"bf16 and an f32 copy, {LLAVA_PATCHES} patches + {SERVE_PROMPT} "
        "tokens)")
    r = logit_checks(tag, ccfg, cparams, prompt, extra={"patches": patches},
                     cache_len=LLAVA_CACHE)
    require_logit_checks(tag, r)
    del cparams, r, patches
    torch.cuda.empty_cache()
    return launches, variants, kinds


# -- phases 19-23: training at full width, and its checks ----------------------

TRAIN_WARMUP, TRAIN_STEPS = 1, 4
TRAIN_MOE_STEPS = 2          # timed steps of [train deepseek-v3] / [llama4]
TRAIN_CHECK_LAYERS = 4


def hybrid_flops(cfg, B: int, S: int) -> float:
    """Model flops of one hybrid forward over B x S tokens: 2 per weight of
    every matrix product per token (each Mamba2 layer's five
    in-projections and its out-projection; once per segment, the shared
    block's four attention projections and three FFN products; the
    unembedding), plus each Mamba2 layer's SSD scan (per chunk of K and
    group: the intra-chunk scores C.B, 2 N per kept (t, s) pair, and
    their product with x, 2 P per pair and head; per token and head the
    chunk state's B x^T and the inter-chunk output C.S, 2 P N each) and
    each segment's causal attention (2 (D + Dv) per kept pair and
    head)."""
    s, d = cfg.ssm, cfg.d_model
    d_inner = s.expand * d
    H, P, N, G = d_inner // s.head_dim, s.head_dim, s.state_dim, s.n_groups
    nseg = attention_blocks(cfg)
    D = cfg.resolved_head_dim
    mamba_w = 2 * d * d_inner + 2 * d * G * N + d * H + d_inner * d
    shared_w = (2 * d * cfg.num_heads * D + 2 * d * cfg.num_kv_heads * D
                + 3 * d * cfg.d_ff)
    weights = (cfg.num_layers * mamba_w + nseg * shared_w
               + d * cfg.vocab_size)
    K = min(s.chunk_size, S)
    while S % K:
        K -= 1
    scan = B * ((S // K) * attention_pairs(K, K, True)
                * (2 * N * G + 2 * P * H) + S * H * 4 * P * N)
    attn = nseg * B * cfg.num_heads * attention_pairs(S, S, True) * 4 * D
    return 2.0 * weights * B * S + cfg.num_layers * scan + attn


def ssm_flops(cfg, B: int, S: int) -> float:
    """Model flops of one rwkv6 forward over B x S tokens: 2 per weight of
    every matrix product per token (each layer's five d x d time-mix
    projections r, k, v, g, out; its ddlerp LoRA, d x 5R and 5 x R x d,
    and decay LoRA, d x R and R x d; the channel mix's d x d_ff pair and
    its d x d receptance; the unembedding), plus each layer's wkv scan
    (per chunk of K and head: the intra-chunk scores a . b, 2 D per kept
    (t, s) pair, the diagonal's bonus counted with them, and their
    product with v, 2 D per pair; per token and head the chunk state's
    k v^T and the inter-chunk output a . S, 2 D^2 each)."""
    from repro_torch.models.rwkv import LORA_R, MIX_R
    d = cfg.d_model
    D = cfg.resolved_head_dim
    H = d // D
    layer_w = (5 * d * d + 10 * MIX_R * d + 2 * LORA_R * d
               + 2 * d * cfg.d_ff + d * d)
    K = min(cfg.ssm.chunk_size, S)
    while S % K:
        K -= 1
    scan = B * H * ((S // K) * attention_pairs(K, K, True) * 4 * D
                    + S * 4 * D * D)
    return (2.0 * (cfg.num_layers * layer_w + d * cfg.vocab_size) * B * S
            + cfg.num_layers * scan)


def encdec_flops(cfg, B: int, S: int) -> float:
    """Model flops of one whisper forward over B x F frames and B x S
    tokens: 2 per weight of every matrix product per frame or token (each
    encoder layer's four attention projections and two FFN products per
    frame; each decoder layer's four self-attention projections, the
    cross attention's q and o, its two FFN products and the unembedding
    per token, and the cross attention's k and v per frame), plus the
    attention's two products (2 (D + Dv) per pair and head): the encoder
    over all F^2 pairs, the decoder's causal self-attention and its cross
    attention over S x F pairs."""
    d, H, D = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    F, n_enc, n_dec = (cfg.encdec.num_frames, cfg.encdec.num_encoder_layers,
                       cfg.num_layers)
    attn_w = 4 * d * H * D
    ffn_w = 2 * d * cfg.d_ff
    per_frame = n_enc * (attn_w + ffn_w) + n_dec * 2 * d * H * D
    per_token = n_dec * (attn_w + 2 * d * H * D + ffn_w) + d * cfg.vocab_size
    pairs = (n_enc * attention_pairs(F, F, False)
             + n_dec * (attention_pairs(S, S, True)
                        + attention_pairs(S, F, False)))
    return 2.0 * (per_frame * F + per_token * S) * B + B * H * pairs * 4 * D


def train_flops(cfg, B: int, S: int) -> float:
    """Model flops of one forward over B x S tokens: 2 per weight of every
    matrix product a token goes through per token (attention's
    projections, GQA's four or MLA's six; the dense FFN's three, or in an
    MoE layer the router, top-k routed experts' and the shared experts'
    three each; the unembedding; with multi-token prediction its
    projection, one more block and the unembedding again), plus the
    causal attention's two products (2 (D + Dv) per kept pair and head).
    Pairs that capacity drops are counted as computed. The vlm family: the
    dense model's over all num_patches + S positions, the unembedding over
    the S text positions only. The hybrid, ssm and encdec families:
    :func:`hybrid_flops`, :func:`ssm_flops`, :func:`encdec_flops`."""
    if cfg.family == "vlm":
        n = cfg.vision.num_patches
        dense = cfg.replace(family="dense", vision=None)
        return (train_flops(dense, B, n + S)
                - 2.0 * cfg.d_model * cfg.vocab_size * B * n)
    if cfg.family == "hybrid":
        return hybrid_flops(cfg, B, S)
    if cfg.family == "ssm":
        return ssm_flops(cfg, B, S)
    if cfg.family == "encdec":
        return encdec_flops(cfg, B, S)
    d, H = cfg.d_model, cfg.num_heads
    if cfg.mla:
        m = cfg.mla
        Dqk, Dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
        attn_w = (d * m.q_lora_rank + m.q_lora_rank * H * Dqk
                  + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                  + m.kv_lora_rank * H * (m.qk_nope_head_dim + Dv)
                  + H * Dv * d)
    else:
        Dqk = Dv = cfg.resolved_head_dim
        attn_w = d * H * Dqk * 2 + d * cfg.num_kv_heads * Dqk * 2
    if cfg.moe:
        e = cfg.moe
        dense_ff = e.d_ff_dense or cfg.d_ff
        moe_w = (d * e.num_experts + 3 * d * e.d_ff_expert * e.top_k
                 + 3 * d * e.d_ff_shared * e.num_shared_experts)
        n_dense = e.first_moe_layer if cfg.family == "moe" else \
            cfg.num_layers
    else:
        dense_ff, moe_w, n_dense = cfg.d_ff, 0, cfg.num_layers
    blocks = [(n_dense, 3 * d * dense_ff),
              (cfg.num_layers - n_dense, moe_w)]
    n_blocks = cfg.num_layers
    weights = sum(n * (attn_w + ffn) for n, ffn in blocks) \
        + d * cfg.vocab_size
    if cfg.mtp_depth:
        weights += (2 * d * d + attn_w + (moe_w if cfg.moe else
                                          3 * d * dense_ff)
                    + d * cfg.vocab_size)
        n_blocks += 1
    attn = n_blocks * B * H * attention_pairs(S, S, True) * 2 * (Dqk + Dv)
    return 2.0 * weights * B * S + attn


class PlainCalls:
    """Counts calls of flash attention's plain forward and backward while
    active (the training and serving paths must make none on the card)."""

    NAMES = ("flash_attention_ref", "flash_attention_lse_ref",
             "flash_attention_bwd_ref")

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref as REF
        self.ref, self.calls = REF, 0
        self.saved = {n: getattr(REF, n) for n in self.NAMES}

        def counted(fn):
            def wrapper(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return wrapper
        for n, fn in self.saved.items():
            setattr(REF, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ref, n, fn)


def train_run(dev, tag, cfg, variant, steps, drops=False, batch=TRAIN_B,
              seq=TRAIN_S):
    """``cfg`` trained at full width with seeded random weights: AdamW with
    the reference's defaults and moments in ``cfg.opt_state_dtype``, B =
    ``batch`` x ``seq`` tokens of data/tokens (for the encdec family with
    the stub frames of ``add_modality_stub``), TRAIN_WARMUP warm-up and
    ``steps`` timed steps, launch counts from 0 before the timed ones:
    the loss, gnorm and lr per step, step ms, tokens/s, model flops over
    step time as a share of 989 TFLOP/s, max_memory_allocated, and a
    1-step profile. Each step must launch K6 for every attention block's
    forward (:func:`attention_blocks`) and again for its remat, K7 once
    per block, all on ``variant`` (None for a model without attention),
    by mask as :func:`want_kinds` says, and no plain attention.
    ``drops``: also the share of pairs each MoE layer drops by capacity.
    Returns the launch counts over the timed steps, K7's by variant, K6's
    and K7's by mask, and the measured step (mean ms, max_memory_allocated
    bytes, the reckoned model flops per step without and with the remat
    forward, B, S) that ``[dryrun]`` holds its predictions against."""
    import torch
    from repro_torch.data import tokens as DATA
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels.flash_attention.bwd_kernel import KERNEL as K7
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.launch import steps as ST
    from repro_torch.models.param import count_params
    from repro_torch.models.registry import Model

    tcfg = TrainConfig()          # the reference's defaults: 3e-4, warmup 100
    model = Model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(
        model, tcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}: {count_params(model.param_descs())} parameters "
        f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.dtype}, remat "
        f"{cfg.remat!r}, AdamW moments {cfg.opt_state_dtype}) and their "
        f"optimizer state made on the card in {time.perf_counter() - t0:.2f} "
        f"s; {torch.cuda.memory_allocated()} B allocated")
    step = ST.make_train_step(model, tcfg)
    B, S = batch, seq
    on_variant = lambda k: k.launches_by_variant[variant] if variant else 0
    batches = [DATA.add_modality_stub(DATA.batch_at(i, cfg, B, S,
                                                    device=dev), cfg, i)
               for i in range(TRAIN_WARMUP + steps + 1)]
    for b in batches[:TRAIN_WARMUP]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    if drops:
        from repro_torch.models import moe as M
        with torch.no_grad():
            shares = moe_drops(lambda: model.loss(state["params"],
                                                  batches[-1]))
        log(f"{tag} pairs dropped by capacity (C = "
            f"{M.capacity(cfg, B * S)} per expert over "
            f"{B * S} tokens x top-{cfg.moe.top_k}) per MoE "
            f"layer of a step: {[f'{x:.4%}' for x in shares]}")
    kernels = all_kernels()
    for k in kernels:
        k.reset_counts()
    want6, want7 = want_launches(cfg)
    kinds6, kinds7 = want_kinds(cfg)
    rows = []
    with PlainCalls() as plain_calls:
        for i, b in enumerate(batches[TRAIN_WARMUP:-1]):
            n6, n7 = K6.launches, K7.launches
            v6, v7 = on_variant(K6), on_variant(K7)
            c6, c7 = dict(K6.launches_by_kind), dict(K7.launches_by_kind)
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rows.append((dt, float(m["loss"]), float(m["gnorm"]),
                         float(m["lr"]), K6.launches - n6,
                         K7.launches - n7,
                         on_variant(K6) - v6, on_variant(K7) - v7,
                         {n: K6.launches_by_kind[n] - c6[n] for n in c6},
                         {n: K7.launches_by_kind[n] - c7[n] for n in c7}))
    launches = {k.name: k.launches for k in kernels}
    variants = dict(K7.launches_by_variant)
    kinds = {"flash_attention": dict(K6.launches_by_kind),
             "flash_attention_bwd": dict(K7.launches_by_kind)}
    peak = torch.cuda.max_memory_allocated()
    tokens = B * S
    fwd = train_flops(cfg, B, S)
    step_s = float(np.mean([r[0] for r in rows]))
    for i, (dt, loss, gnorm, lr, n6, n7, w6, w7, k6, k7) in enumerate(rows):
        log(f"{tag} step {TRAIN_WARMUP + i}: loss {loss:.5f} gnorm "
            f"{gnorm:.5f} lr {lr:.3e}, {dt * 1e3:.3f} ms, flash_attention "
            f"{n6} launches ({w6} {variant}; by mask {k6}), "
            f"flash_attention_bwd {n7} ({w7} {variant}; by mask {k7})")
        require(np.isfinite(loss) and np.isfinite(gnorm),
                f"{tag} non-finite loss or gradient norm")
        require(n6 == want6 and n7 == want7,
                f"{tag} a step launched flash_attention {n6} times and "
                f"flash_attention_bwd {n7} times, expected {want6} "
                f"(forward{' + remat' if want6 > want7 else ''}) and "
                f"{want7}")
        require(variant is None or (w6 == n6 and w7 == n7),
                f"{tag} {n6 - w6} of a step's {n6} flash_attention and "
                f"{n7 - w7} of its {n7} flash_attention_bwd launches did "
                f"not run the {variant} kernels")
        require(k6 == kinds6 and k7 == kinds7,
                f"{tag} a step launched flash_attention {k6} and "
                f"flash_attention_bwd {k7} by mask, expected {kinds6} and "
                f"{kinds7}")
    require(plain_calls.calls == 0, f"{tag} {plain_calls.calls} calls of "
                                    "the plain attention on the card")
    share = lambda flops: 100 * flops / step_s / BF16_OPS_PER_S
    log(f"{tag} {steps} timed steps of B={B} x {S} "
        f"tokens: mean {step_s * 1e3:.3f} ms per step, "
        f"{tokens / step_s:.1f} tokens/s; model flops per step "
        f"{3 * fwd:.4e} (forward + backward: {share(3 * fwd):.2f} % of "
        f"{BF16_OPS_PER_S:.3g} FLOP/s), {4 * fwd:.4e} with the remat "
        f"forward ({share(4 * fwd):.2f} %); max_memory_allocated {peak} B; "
        f"launches {launches}")
    profile_window(tag.strip("[]").replace(" ", "-"),
                   lambda: step(state, batches[-1]), 1, "step")
    del state, batches
    torch.cuda.empty_cache()
    measured = {"step_ms": step_s * 1e3, "peak_bytes": peak,
                "model_flops": 3 * fwd, "model_flops_remat": 4 * fwd,
                "batch": B, "seq": S}
    return launches, variants, kinds, measured


def train_phase(dev):
    """granite-3-2b training at full width (see the module docstring):
    remat, f32 moments, every attention on the wgmma kernels."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-2b")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "float32",
            "[train] granite-3-2b should train under remat='full' with f32 "
            "moments")
    return train_run(dev, "[train]", cfg, "wgmma", TRAIN_STEPS)


def train_deepseek_phase(dev):
    """deepseek-v3 at full width cut to its 3 dense layers (MLA + the
    18432-wide FFN; one MoE layer alone holds 11.3e9 expert parameters),
    the MTP block left out, full untied vocabulary, bf16 AdamW moments
    (its config's): K6 and K7 on the wgmma kernels (D = 192, Dv = 128)."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "bfloat16",
            "[train deepseek-v3] deepseek-v3 should train under "
            "remat='full' with bf16 moments")
    cfg = cfg.replace(num_layers=cfg.moe.first_moe_layer, mtp_depth=0)
    return train_run(dev, "[train deepseek-v3]", cfg, "wgmma",
                     TRAIN_MOE_STEPS)


def train_zamba2_phase(dev):
    """zamba2-2.7b training at full width, not cut (54 Mamba2 layers, the 2
    shared blocks called 9 times, untied vocabulary): remat, f32 moments,
    K6 (2 x 9: the forward and its remat) and K7 (9) per step on their
    SIMT kernels (head dim 80)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-2.7b")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "float32",
            "[train zamba2-2.7b] zamba2-2.7b should train under "
            "remat='full' with f32 moments")
    return train_run(dev, "[train zamba2-2.7b]", cfg, "simt",
                     TRAIN_MOE_STEPS)


def train_rwkv_phase(dev):
    """rwkv6-3b training at full width, not cut (32 layers, untied
    vocabulary): remat, f32 moments, no attention, so no K6 or K7 launch
    and no plain attention call."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-3b")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "float32",
            "[train rwkv6-3b] rwkv6-3b should train under remat='full' "
            "with f32 moments")
    return train_run(dev, "[train rwkv6-3b]", cfg, None,
                     TRAIN_MOE_STEPS)


def train_whisper_phase(dev):
    """whisper-tiny training at full width, not cut: B = 8 x 448 tokens
    with 1500 stub frames each, remat on the decoder, f32 moments: K6 4
    times without a mask (the encoder, not rematerialised) and 2 x 4
    causal (the decoder's forward and its remat), K7 4 + 4, all wgmma.
    Returns the launch counts, K7's by variant and K6's and K7's by
    mask."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "float32",
            "[train whisper-tiny] whisper-tiny should train under "
            "remat='full' with f32 moments")
    return train_run(dev, "[train whisper-tiny]", cfg, "wgmma",
                     TRAIN_MOE_STEPS, batch=WHISPER_TRAIN_B,
                     seq=WHISPER_CACHE)


LLAVA_TRAIN_LAYERS = 12      # of 32: whole, with f32 moments, ~87 GB


def train_llava_phase(dev):
    """llava-next-mistral-7b at full width cut to 12 of its 32 layers (the
    whole model's weights, gradients and f32 moments would take ~87 GB),
    the full untied 32,000-row vocabulary, f32 moments (its config's),
    remat; B = 4 x 1024 text tokens, each after its 2880 stub patches: K6
    2 x 12 (the forward and its remat) and K7 12 per step, causal, all
    wgmma over 3904 positions; the model flops count every position, the
    unembedding the text only. Returns the launch counts, K7's by variant
    and K6's and K7's by mask."""
    from repro_torch.configs import get_config
    cfg = get_config("llava-next-mistral-7b")
    require(cfg.remat == "full" and cfg.opt_state_dtype == "float32",
            "[train llava-next-mistral-7b] llava should train under "
            "remat='full' with f32 moments")
    return train_run(dev, "[train llava-next-mistral-7b]",
                     cfg.replace(num_layers=LLAVA_TRAIN_LAYERS), "wgmma",
                     TRAIN_MOE_STEPS)


def train_llama4_phase(dev):
    """llama4-scout at full width cut to 1 of its 48 layers: all 16
    experts whole, the shared expert, the full untied 202,048-row
    vocabulary, f32 moments; attention (D = 128, group 5) on the wgmma
    kernels; the share of pairs capacity drops."""
    from repro_torch.configs import get_config
    cfg = get_config("llama4-scout-17b-a16e").replace(num_layers=1)
    return train_run(dev, "[train llama4-scout]", cfg, "wgmma",
                     TRAIN_MOE_STEPS, drops=True)


def leaf_errs(grads, ref):
    """{path: max |g - g_ref| / max |g_ref|} of every non-empty gradient
    leaf (a stack cut to 0 layers has empty ones)."""
    from repro_torch.optim import adamw
    return {"/".join(p): float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for p, a, b in zip(adamw.paths(ref), adamw.leaves(grads),
                               adamw.leaves(ref)) if b.numel()}


def bf16_step_check(dev, cfg, batch=TRAIN_B, seq=TRAIN_S):
    """One step's loss and gradients of the bf16 ``cfg`` at full width on
    ``batch`` x ``seq`` tokens: with the kernels, plain (backend="ref"),
    and an f32 copy on the plain versions, on the same weights and batch;
    each bf16 run's gradients are held against the f32 ones as soon as
    they exist, so at most one bf16 gradient tree lives beside the f32
    one. The kernel run must be no further from f32 than the plain run is
    (x1.5), over the gradient leaves' worst relative error."""
    import torch
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    params32 = adamw.tree_map(lambda t: t.float(), params)
    B, S = batch, seq
    batch = DATA.add_modality_stub(
        DATA.batch_at(0, cfg, B, S, seed=1, device=dev), cfg, 0, seed=1)
    loss = {}
    loss["f32"], ref = ST.loss_and_grads(
        Model(cfg32, device=dev, backend="ref"), params32, batch)
    del params32
    torch.cuda.empty_cache()
    errs = {}
    for run, backend in (("kernels", None), ("plain", "ref")):
        loss[run], grads = ST.loss_and_grads(
            Model(cfg, device=dev, backend=backend), params, batch)
        errs[run] = leaf_errs(grads, ref)
        del grads
        torch.cuda.empty_cache()
    loss = {run: float(x) for run, x in loss.items()}
    log(f"[train check] {cfg.name} at full width, {cfg.num_layers} layers, "
        f"B={B} x {S}: loss kernels {loss['kernels']:.6f}, "
        f"plain {loss['plain']:.6f}, f32 {loss['f32']:.6f}")
    log("[train check] gradient leaves, max |g - g_f32| / max |g_f32| "
        "(kernels, plain): " + ", ".join(
            f"{n}: ({k:.2e}, {errs['plain'][n]:.2e})"
            for n, k in errs["kernels"].items()))
    worst_k = max(errs["kernels"].values())
    worst_p = max(errs["plain"].values())
    log(f"[train check] {cfg.name} worst leaf: kernels {worst_k:.3e}, "
        f"plain {worst_p:.3e} (held: kernels <= {B_RATIO:g} x plain)")
    require(all(np.isfinite(list(errs["kernels"].values()))),
            "[train check] non-finite gradient")
    require(worst_k <= B_RATIO * worst_p, f"[train check] {cfg.name}: the "
                                          "bf16 kernel step is further "
                                          "from f32 than the bf16 plain "
                                          "step is")
    del ref, params
    torch.cuda.empty_cache()


MOE_GRAD_TOL = 1e-4   # f32 gradient leaves, kernels vs plain, of max |g|


def want_kinds(cfg):
    """(K6's, K7's) launches of one training step of ``cfg`` by mask: K6
    for every attention block's forward and again for its remat, K7 once
    per block; the MTP block and whisper's encoder (the only unmasked
    attention), not rematerialised, launch each once."""
    mtp = 1 if cfg.mtp_depth else 0
    kinds = blocks_by_kind(cfg)
    remat = 2 if cfg.remat == "full" else 1
    return ({"causal": remat * kinds["causal"] + mtp, "full": kinds["full"]},
            {"causal": kinds["causal"] + mtp, "full": kinds["full"]})


def want_launches(cfg):
    """(K6, K7) launches of one training step of ``cfg``
    (:func:`want_kinds` summed)."""
    k6, k7 = want_kinds(cfg)
    return sum(k6.values()), sum(k7.values())


def f32_step_check(dev, cfg, seed: int, what: str, batch=TRAIN_B,
                   seq=TRAIN_S):
    """One step's loss and gradients of the f32 ``cfg`` with the kernels
    against the plain versions on the same weights and ``batch`` x ``seq``
    tokens: the loss within 1e-5 relative, every gradient leaf within
    MOE_GRAD_TOL of its largest element; K6 and K7 launch as
    :func:`want_launches` says, and no plain attention runs."""
    import torch
    from repro_torch.data import tokens as DATA
    from repro_torch.kernels.flash_attention.bwd_kernel import KERNEL as K7
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import Model

    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    B, S = batch, seq
    batch = DATA.add_modality_stub(
        DATA.batch_at(0, cfg, B, S, seed=seed - 2, device=dev),
        cfg, 0, seed=seed - 2)
    n6, n7 = K6.launches, K7.launches
    with PlainCalls() as plain:
        loss, grads = ST.loss_and_grads(model, params, batch)
    launched = (K6.launches - n6, K7.launches - n7)
    ploss, pgrads = ST.loss_and_grads(Model(cfg, device=dev, backend="ref"),
                                      params, batch)
    errs = leaf_errs(grads, pgrads)
    worst = max(errs, key=errs.get)
    want = want_launches(cfg)
    log(f"[train check] {cfg.name} ({what}) in f32, {cfg.num_layers} "
        f"layers, B={B} x {S}: loss kernels {float(loss):.7f}, "
        f"plain {float(ploss):.7f}; flash_attention, flash_attention_bwd "
        f"launches {launched}, plain attention calls {plain.calls}; worst "
        f"gradient leaf {worst} {errs[worst]:.3e} of its max (held <= "
        f"{MOE_GRAD_TOL:g})")
    require(launched == want and plain.calls == 0,
            f"[train check] {cfg.name} launched flash_attention and "
            f"flash_attention_bwd {launched} times with {plain.calls} plain "
            f"attention calls, expected {want} and none")
    require(abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss)),
            f"[train check] {cfg.name}: the kernel loss differs from the "
            "plain loss")
    require(errs[worst] <= MOE_GRAD_TOL, f"[train check] {cfg.name}: a "
                                       "gradient leaf differs from the "
                                       "plain one")
    del params, grads, pgrads
    torch.cuda.empty_cache()


def moe_step_check(dev):
    """deepseek-v3 at REDUCED width with its MoE layers and MTP block, in
    f32 (a bf16 rounding moves tokens between experts), by
    :func:`f32_step_check`: K6 and K7 launch once per layer and once for
    the MTP block (no remat)."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    require(cfg.remat == "none", f"[train check] REDUCED {cfg.name} should "
                                 "not rematerialise")
    f32_step_check(dev, cfg, 4, "MoE, MLA, MTP")


def zamba2_step_checks(dev):
    """zamba2-2.7b at full width cut to 12 layers (2 segments, both shared
    blocks): in bf16 by :func:`bf16_step_check`, and in f32, remat on,
    kernels against plain per gradient leaf by :func:`f32_step_check`."""
    from repro_torch.configs import get_config
    zamba = get_config("zamba2-2.7b")
    zamba = zamba.replace(num_layers=2 * zamba.hybrid.attn_every)
    bf16_step_check(dev, zamba)
    f32_step_check(dev, zamba.replace(dtype="float32",
                                      param_dtype="float32"), 5,
                   "hybrid, remat, head dim 80")


def whisper_step_checks(dev):
    """whisper-tiny whole at its training shape (WHISPER_TRAIN_B x
    WHISPER_CACHE tokens, 1500 stub frames each: the decoder's causal tiles
    ragged at 448): in bf16 by :func:`bf16_step_check`, and in f32, remat
    on, kernels against plain per gradient leaf by :func:`f32_step_check`
    (K6 4 + 2 x 4, K7 4 + 4: the encoder's unmasked attention among
    them)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    shape = dict(batch=WHISPER_TRAIN_B, seq=WHISPER_CACHE)
    bf16_step_check(dev, cfg, **shape)
    f32_step_check(dev, cfg.replace(dtype="float32", param_dtype="float32"),
                   6, "encdec, remat, non-causal encoder", **shape)


# [train check]'s pipeline: ("pod", "data") = (2, 2), 2 microbatches, 2
# blocks per stage, B = 8 x 1024 tokens
PIPE_MESH, PIPE_MICRO, PIPE_B = (2, 2), 2, 8


def llava_step_checks(dev):
    """llava-next-mistral-7b at full width cut to 4 layers: in bf16 by
    :func:`bf16_step_check` at B = 2 x 1024 tokens after the 2880 patches;
    then :func:`compression_check` and :func:`pipeline_check` on the same
    cut."""
    from repro_torch.configs import get_config
    cfg = get_config("llava-next-mistral-7b").replace(
        num_layers=TRAIN_CHECK_LAYERS)
    bf16_step_check(dev, cfg, batch=2)
    compression_check(dev, cfg.replace(dtype="float32",
                                       param_dtype="float32"))
    pipeline_check(dev, cfg)


def compression_check(dev, cfg):
    """``optim.compression.compressed_psum`` over the 4 emulated ranks of a
    ("pod", "data") = (2, 2) mesh, on the f32 gradients of ``cfg`` (llava
    cut to 4 layers, f32) from 4 batches of 1 x 1024 tokens after their
    patches, one per rank, leaf by leaf; two rounds, the second on the
    next 4 batches with the first round's residuals carried in.
    Every element of a round's mean lies within scale / 2 of the exact
    (f64) mean of g + err, plus the f32 rounding of x / scale (127 x 2^-23
    x scale) and of the mean (2 x 2^-23 of its largest element); every
    residual equals x - q * scale (x = g + err, q = round(x / scale))
    rounded once; every rank gets the same mean."""
    import torch
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import EmulatedMesh
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as C

    tag = "[train check] compression"
    mesh = EmulatedMesh(("pod", "data"), PIPE_MESH, dev)
    ranks = mesh.size
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(7))

    def grads(step):
        out = []
        for r in range(step * ranks, (step + 1) * ranks):
            b = DATA.add_modality_stub(DATA.batch_at(
                r, cfg, 1, SERVE_PROMPT, seed=9, device=dev), cfg, r, seed=9)
            out.append(adamw.leaves(ST.loss_and_grads(model, params, b)[1]))
        return out

    names = ["/".join(p) for p in adamw.paths(params)]
    err = [None] * len(names)            # each leaf's residuals, on the host
    worst = {}
    eps = float(torch.finfo(torch.float32).eps)
    t0 = time.perf_counter()
    for rnd in range(2):
        per_rank = grads(rnd)
        for i, name in enumerate(names):
            g = torch.stack([leaves[i] for leaves in per_rank])
            for leaves in per_rank:
                leaves[i] = None
            e = (C.init_error(g) if err[i] is None
                 else err[i].to(dev, non_blocking=True))
            mean, resid = C.compressed_psum({"g": g}, {"g": e}, mesh,
                                            ("pod", "data"))
            mean, resid = mean["g"], resid["g"]
            scale = torch.clamp((g.float() + e).abs().max(), min=1e-12) / 127.0
            require(all(torch.equal(m, mean[0]) for m in mean),
                    f"{tag} round {rnd} {name}: the ranks' means differ")
            # the exact mean and x - q * scale rounded once, slice by slice
            gap, same, biggest = 0.0, True, 0.0
            flat = lambda t: t.reshape(ranks, -1)
            for j in range(0, flat(g).shape[1], C.CHUNK):
                sl = slice(j, j + C.CHUNK)
                x = flat(g)[:, sl].float() + flat(e)[:, sl]
                exact = x.double().mean(0)
                gap = max(gap, float((flat(mean)[0, sl].double() - exact)
                                     .abs().max()))
                biggest = max(biggest, float(exact.abs().max()))
                q = torch.clamp(torch.round(x / scale), -127, 127)
                same &= torch.equal(flat(resid)[:, sl], (
                    x.double() - q.double() * scale.double()).float())
            slack = eps * (127 * float(scale) + 2 * biggest)
            require(gap <= float(scale) / 2 + slack,
                    f"{tag} round {rnd} {name}: the mean is {gap:.3e} from "
                    f"the exact mean, past scale / 2 = {float(scale) / 2:.3e}")
            require(same, f"{tag} round {rnd} {name}: a residual is not x - "
                          "q * scale rounded once")
            worst[name] = max(worst.get(name, 0.0), gap / float(scale))
            err[i] = resid.cpu()
            del g, e, mean, resid
        del per_rank
    top = [(n, f"{worst[n]:.4f}")
           for n in sorted(worst, key=worst.get, reverse=True)[:3]]
    log(f"{tag}: compressed_psum over {ranks} emulated ranks of {PIPE_MESH} "
        f"(\"pod\", \"data\"), {len(names)} f32 gradient leaves of "
        f"{cfg.name} at {cfg.num_layers} layers, two rounds (residuals "
        f"carried): worst |mean - exact mean| / scale {top} (held <= 0.5 + "
        f"f32 rounding); every residual x - q * scale rounded once; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, err
    torch.cuda.empty_cache()


def pipeline_check(dev, cfg):
    """``distributed.pipeline.pipeline_apply`` on an emulated ("pod",
    "data") = (2, 2) mesh with 2 microbatches, in bf16, at B = 8 x 1024
    tokens (their embeddings): ``stage_fn`` runs 2 of ``cfg``'s full-width
    blocks per stage. The output equals the 4 blocks applied in order to
    each microbatch, bit for bit, and to the whole batch at once within
    2e-2 of its largest element; K6 launches 2 data shards x 2
    microbatches x 2 stages x 2 blocks = 16 times, all wgmma."""
    import torch
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.launch.mesh import EmulatedMesh
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw

    tag = "[train check] pipeline"
    mesh = EmulatedMesh(("pod", "data"), PIPE_MESH, dev)
    stages, shards = mesh.shape["pod"], mesh.shape["data"]
    per_stage = cfg.num_layers // stages
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(8))
    stack = params["stack_0_dense"]
    staged = adamw.tree_map(
        lambda a: a.reshape(stages, per_stage, *a.shape[1:]), stack)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_B, SERVE_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(9), device=dev)

    def stage_fn(p, h, sid):
        for lp in LM.unstack(p, per_stage):
            h = LM.block_train(lp, h, cfg)
        return h

    def blocks(h):
        for lp in LM.unstack(stack, cfg.num_layers):
            h = LM.block_train(lp, h, cfg)
        return h

    with torch.no_grad():
        x = L.embed(params["embed"], tokens)
        n6, w6 = K6.launches, K6.launches_by_variant["wgmma"]
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            got = pipeline_apply(stage_fn, staged, x, mesh, axis="pod",
                                 num_micro=PIPE_MICRO)
            torch.cuda.synchronize()
            pipe_ms = (time.perf_counter() - t0) * 1e3
        launched = (K6.launches - n6, K6.launches_by_variant["wgmma"] - w6)
        micro = PIPE_B // shards // PIPE_MICRO
        each = torch.cat([blocks(m) for m in x.split(micro)])
        whole = blocks(x)
    want = shards * PIPE_MICRO * stages * per_stage
    gap = float((got.float() - whole.float()).abs().max()) / float(
        whole.float().abs().max())
    log(f"{tag}: pipeline_apply over {PIPE_MESH} (\"pod\", \"data\"), "
        f"{PIPE_MICRO} microbatches of {micro} rows, {per_stage} of "
        f"{cfg.name}'s blocks per stage, B={PIPE_B} x {SERVE_PROMPT} tokens, "
        f"bf16: {pipe_ms:.1f} ms; == the blocks per microbatch bit for bit "
        f"{torch.equal(got, each)}; vs the whole batch at once "
        f"{gap:.3e} of its max (held <= 2e-2); K6 launches {launched[0]} "
        f"({launched[1]} wgmma; expected {want}), plain attention calls "
        f"{plain.calls}")
    require(torch.equal(got, each), f"{tag}: the pipeline differs from the "
                                    "blocks applied per microbatch")
    require(gap <= 2e-2, f"{tag}: the pipeline differs from the whole batch")
    require(launched == (want, want) and plain.calls == 0,
            f"{tag}: K6 launched {launched} (all, wgmma), expected {want}")
    del params, stack, staged, x, got, each, whole
    torch.cuda.empty_cache()


def train_check_phase(dev):
    """granite-3-2b with 4 layers and deepseek-v3's 3 dense layers, at
    full width, by :func:`bf16_step_check`; the moe family with MTP at
    REDUCED width by :func:`moe_step_check`; the zamba2 cut by
    :func:`zamba2_step_checks`; whisper-tiny by
    :func:`whisper_step_checks`; llava's 4-layer cut, compression and the
    pipeline by :func:`llava_step_checks`."""
    from repro_torch.configs import get_config
    bf16_step_check(dev, get_config("granite-3-2b").replace(
        num_layers=TRAIN_CHECK_LAYERS))
    ds = get_config("deepseek-v3-671b")
    bf16_step_check(dev, ds.replace(num_layers=ds.moe.first_moe_layer,
                                    mtp_depth=0))
    moe_step_check(dev)
    zamba2_step_checks(dev)
    whisper_step_checks(dev)
    llava_step_checks(dev)


# -- phase 24: the four examples on the card -----------------------------------

def load_example(name: str):
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev):
    """examples/torch_*.py, each through its ``run`` on the card."""
    import shutil
    quiet = lambda *a, **k: None
    t0 = time.perf_counter()
    q = load_example("torch_quickstart").run(str(dev), log=quiet)
    require(all(r["features"] > 0 and r["bad_checksum"] == 0
                for r in q["periods"]) and q["ring_entries"] > 0,
            "[examples] quickstart enriched no flow")
    log(f"[examples] torch_quickstart: "
        f"{[r['features'] for r in q['periods']]} feature vectors per "
        f"period, {q['ring_entries']} ring entries "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    s = load_example("torch_serve_traffic_inference").run(str(dev),
                                                         log=quiet)
    r = s["report"]
    require(r.balanced and r.dropped > 0, "[examples] serving accounting "
                                          "does not balance")
    log(f"[examples] torch_serve_traffic_inference: offered {r.offered} == "
        f"processed {r.processed} + dropped {r.dropped}; p50 "
        f"{r.latency['p50']:.1f} us, p99 {r.latency['p99']:.1f} us over "
        f"{r.periods} + {r.drained_periods} periods; stage-2 tokens "
        f"{s['tokens'].tolist()} ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    c = load_example("torch_train_flow_classifier").run(str(dev), log=quiet)
    require(c["accuracy"] > 0.85, f"[examples] classifier accuracy "
                                  f"{c['accuracy']:.3f} <= 0.85")
    log(f"[examples] torch_train_flow_classifier: {len(c['X'])} feature "
        f"vectors, loss {c['losses'][0]:.4f} -> {c['losses'][-1]:.4f}, "
        f"held-out accuracy {c['accuracy']:.3f} "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    lm = load_example("torch_train_lm_e2e")
    ckpt = ROOT / "build" / "torch_example_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = lm.run(str(dev), ckpt_dir=ckpt, log=quiet)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    require(last < first - 0.2, f"[examples] LM loss did not fall: "
                                f"{first:.4f} -> {last:.4f}")
    log(f"[examples] torch_train_lm_e2e: {len(losses)} steps, loss "
        f"{first:.4f} -> {last:.4f} ({time.perf_counter() - t0:.2f} s)")


# -- card clocks around each timed phase --------------------------------------

def clocks(tag: str, when: str) -> None:
    """Log the card's SM and memory clocks, power draw and temperature as
    ``nvidia-smi`` reads them (``[clocks] <tag> start|end: ...``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[clocks] {tag} {when}: {out}")


def phase(tag: str, fn, *args):
    """``fn(*args)`` between two :func:`clocks` lines."""
    clocks(tag, "start")
    out = fn(*args)
    clocks(tag, "end")
    return out


# -- [tune]: K1's event tile on the main path's stream --------------------------

TUNE_TILES = (64, 128, 256)
TUNING_FILE = ROOT / "build" / "repro_torch_tuning.json"
TUNE_FORCED = 64                     # a registry that forces this tile


def one_period(system, events, nows, t: int = 0):
    """``dfa_step`` on period ``t`` of the main path's traffic from a fresh
    state, launch counts from 0; returns (outputs, K1's launches by
    kind)."""
    import torch
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    K1.reset_counts()
    out = system.dfa_step(system.init_state(),
                          {k: v[t] for k, v in events.items()}, nows[t])
    torch.cuda.synchronize()
    return out, {k: n for k, n in K1.launches_by_kind.items() if n}


def require_outputs_identical(a, b, tag):
    """Every state leaf, the features and the preds, bit for bit."""
    import torch
    require_states_equal(a.state, b.state, tag)
    for name in ("enriched", "flow_ids", "mask", "preds"):
        x, y = getattr(a, name), getattr(b, name)
        require(torch.equal(x.view(torch.int32) if x.is_floating_point()
                            else x,
                            y.view(torch.int32) if y.is_floating_point()
                            else y), f"[{tag}] {name} differs")


def tune_phase(dev, system, events, nows):
    """K1 at E = 2^20 on the main path's sorted stream (``check_ingest``'s)
    at event tiles 64, 128 and 256, timed by its device time in a
    profiler window that saw one K1 launch per call, each beside its
    bound; all three recorded in a ``TuningRegistry`` (which keeps the
    fastest) saved to build/repro_torch_tuning.json. Then one main-path
    period with ``REPRO_TUNING_REGISTRY`` at that file, and one at a
    registry that forces tile 64: each launches K1 once with its tile
    (``KERNEL.launches_by_kind``) and gives the untuned period's state,
    features and preds bit for bit; ``describe()`` names the armed file.
    A registry armed at a malformed file must raise."""
    import os
    import torch
    from repro_torch.configs import PAPER
    from repro_torch.configs import env as ENV
    from repro_torch.core import reporter as REP
    from repro_torch.data import packets as PK
    from repro_torch.kernels import tuning as TU
    from repro_torch.kernels.ingest_update import kernel as K
    from repro_torch.kernels.ingest_update import ops

    flows = PK.gen_flows(PAPER.flows_per_shard, seed=0)
    ev = PK.events_to_torch(PK.gen_events(flows, 0, 20_000, EVENTS, seed=1),
                            dev)
    st = REP.init_state(PAPER, dev)
    slots = REP.hash_slot(ev["five_tuple"], PAPER.flows_per_shard)
    n_lut = 1 << PAPER.logstar_bits
    reg = TU.TuningRegistry()
    knob = "ingest_update.event_tile"
    for tile in TUNE_TILES:
        s = K.stream_prep(st.last_ts, st.keys, st.active, slots, ev["ts"],
                          ev["size"], ev["five_tuple"], ev["valid"], tile)
        require(s.tile == tile, f"[tune] stream_prep took tile {s.tile}, "
                                f"asked {tile}")
        args = (s.s_slot, s.s_ts, s.s_ps, s.base_ts,
                s.first.to(torch.int32))
        kw = dict(bits=PAPER.logstar_bits, tile=tile)
        got = ops.segment_sums(*args, **kw)
        want = ops.segment_sums(*args, **kw, backend="ref")
        require(torch.equal(got, want), f"[tune] K1 at tile {tile} differs "
                                        f"from its plain version")
        # a profiler window can lose device events (ROADMAP §3): keep only
        # a window that saw K1 once per call, or the registry would record
        # a time from a fraction of the launches
        for attempt in range(3):
            us, n = device_profile(K.KERNEL,
                                   lambda: ops.segment_sums(*args, **kw))
            if n == 1:
                break
            log(f"[tune] attempt {attempt + 1} at tile {tile}: the profiler "
                f"saw {n:g} device launches per call; profiling again")
        require(n == 1, f"[tune] no profiler window saw K1 once per call at "
                        f"tile {tile}")
        Ep = s.s_slot.shape[0]
        b_ms, b_by = bound(Ep * (5 * 4 + 8 * 4) + 2 * n_lut * 4,
                           Ep * (4 * 30 + 7 * max(1, tile.bit_length() - 1)))
        stored = reg.record(knob, "cuda", (EVENTS,), tile, us,
                            source="chip_smoke [tune]")
        log(f"[tune] K1 at E={EVENTS}, tile {tile}: device {us:.3f} us "
            f"({n:g} device launches per call), bound {b_ms * 1e3:.2f} us "
            f"({b_by}), {100 * b_ms * 1e3 / us:.1f} % of the bound; "
            f"{'the fastest so far' if stored else 'slower'}")
    TUNING_FILE.parent.mkdir(parents=True, exist_ok=True)
    reg.save(str(TUNING_FILE))
    best = reg.lookup(knob, "cuda", (EVENTS,))
    log(f"[tune] tile {best} written to "
        f"{TUNING_FILE.relative_to(ROOT)}: {TUNING_FILE.read_text()!r}")

    forced = TUNING_FILE.with_name("repro_torch_tuning_forced.json")
    f_reg = TU.TuningRegistry()
    f_reg.record(knob, "cuda", (EVENTS,), TUNE_FORCED, 0.0,
                 source="chip_smoke [tune], forced")
    f_reg.save(str(forced))
    bad = TUNING_FILE.with_name("repro_torch_tuning_bad.json")
    bad.write_text('{"schema": "repro-tuning-v1", "entries": [{"knob": ')

    var = ENV.TUNING_REGISTRY.name
    before = os.environ.pop(var, None)
    try:
        base, base_tiles = one_period(system, events, nows)
        log(f"[tune] untuned period: K1 launches by tile {base_tiles}")
        for path, tile in ((TUNING_FILE, best), (forced, TUNE_FORCED)):
            os.environ[var] = str(path)
            out, tiles = one_period(system, events, nows)
            desc = system.describe()
            require(tiles == {f"tile {tile}": 1},
                    f"[tune] the period armed at {path.name} launched K1 "
                    f"by tile {tiles}, expected tile {tile} once")
            require(desc["tuning_registry"] == str(path),
                    f"[tune] describe() names {desc['tuning_registry']}")
            require_outputs_identical(out, base, f"tune {path.name}")
            log(f"[tune] period armed at {path.relative_to(ROOT)}: K1 "
                f"launches by tile {tiles}; state, features and preds "
                f"equal to the untuned period bit for bit; describe() "
                f"tuning_registry {desc['tuning_registry']!r}")
        os.environ[var] = str(bad)
        try:
            one_period(system, events, nows)
        except ValueError as e:
            log(f"[tune] a registry armed at a malformed file raises: "
                f"{type(e).__name__}: {str(e)[:120]}")
        else:
            require(False, "[tune] a malformed registry did not raise")
    finally:
        if before is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = before


# -- [dryrun]: the dry run on meta tensors, held against the card ----------------

DRYRUN_DIR = ROOT / "build" / "dryrun"
# production cells: (arch, shape, on the 2 x 16 x 16 multi-pod mesh)
DRYRUN_PRODUCTION = (("granite-3-2b", "train_4k", False),
                     ("deepseek-v3-671b", "decode_32k", True),
                     ("zamba2-2.7b", "long_500k", False))
# one-card training cells at B = TRAIN_B x TRAIN_S: (arch, layers (None =
# whole), whether it must fit the card)
DRYRUN_CARD = (("granite-3-2b", None, True),
               ("llava-next-mistral-7b", LLAVA_TRAIN_LAYERS, True),
               ("llava-next-mistral-7b", None, False),
               ("deepseek-v3-671b", None, False))
DRYRUN_SHAPE = ("train_b4_s1024", "train", TRAIN_S, TRAIN_B)


def dryrun_cells(hbm_bytes: int, hbm_source: str) -> None:
    """[dryrun]'s host work, run by :class:`DryrunJob` in a process that
    sees no card: the production cells and the one-card cells through
    ``launch.dryrun.run_cell`` on meta tensors, each cell's JSON under
    build/dryrun/, all of them in build/dryrun/chip_cells.json."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh

    hbm = (hbm_bytes, hbm_source)
    out = {"production": [], "card": []}
    for arch, shape, multi_pod in DRYRUN_PRODUCTION:
        out["production"].append(D.run_cell(arch, shape, multi_pod,
                                            str(DRYRUN_DIR), hbm=hbm))
        print(D.summary(out["production"][-1], f"{arch} {shape}"),
              flush=True)
    shape = ShapeConfig(*DRYRUN_SHAPE)
    mesh = make_local_mesh(1, device="meta")
    for arch, layers, _ in DRYRUN_CARD:
        cfg = get_config(arch)
        out["card"].append(D.run_cell(
            arch, shape.name, False, str(DRYRUN_DIR),
            cfg=cfg.replace(num_layers=layers or cfg.num_layers),
            shape=shape, mesh=mesh, hbm=hbm))
        print(D.summary(out["card"][-1], f"{arch} {layers or 'whole'}"),
              flush=True)
    (DRYRUN_DIR / "chip_cells.json").write_text(json.dumps(out))


class DryrunJob:
    """:func:`dryrun_cells` in a child process with no card visible
    (``CUDA_VISIBLE_DEVICES=""``: it allocates nothing on the card and
    launches no kernel), its output in build/dryrun/child.log, against
    the card's HBM as read here; stopped at exit if still running."""

    def __init__(self):
        import atexit
        import os
        from repro_torch.launch import dryrun as D
        hbm, source = D.hbm_budget()
        DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
        self.log_path = DRYRUN_DIR / "child.log"
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; chip_smoke.dryrun_cells({hbm}, "
                f"{source!r})")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as f:
            self.proc = subprocess.Popen([sys.executable, "-c", code],
                                         stdout=f, stderr=subprocess.STDOUT,
                                         cwd=str(ROOT), env=env)
        atexit.register(self.stop)
        log(f"[dryrun] host process {self.proc.pid} started on meta "
            f"tensors (HBM budget {hbm} B, {source})")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self, timeout: float):
        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=timeout)
        log(f"[dryrun] host process exit {rc} after "
            f"{time.perf_counter() - self.t0:.1f} s (waited "
            f"{time.perf_counter() - t0:.1f} s for it)")
        for line in self.log_path.read_text().splitlines():
            log(f"[dryrun] (host) {line}")
        require(rc == 0, f"[dryrun] the host process exited {rc}")
        return json.loads((DRYRUN_DIR / "chip_cells.json").read_text())


def dryrun_phase(job: DryrunJob, measured) -> None:
    """The dry run's cells (:func:`dryrun_cells`): the three production
    cells' reference-style lines (no collective term: every mesh is
    emulated on one device), then the one-card cells: ``fits_hbm`` true
    for granite-3-2b whole and llava-next-mistral-7b's 12-layer cut,
    false for llava whole and deepseek-v3 whole; for the two cuts the
    card trained (``measured``: arch -> train_run's numbers), the dry
    run's FLOPs per step, step-time lower bound and predicted peak beside
    the measured step ms, the reckoned model flops and
    max_memory_allocated, with their ratios (no tolerance: remat's forward
    and the plain attention's score chunks on meta are explained in
    PERF.md)."""
    from repro_torch.launch import dryrun as D
    cells = job.result(timeout=900)
    for res in cells["production"]:
        log(D.summary(res, f"{res['arch']} {res['shape']} "
                           f"pod{2 if res['multi_pod'] else 1}"))
        require(not res["skipped"] and res["roofline"]["collective_s"] is None,
                f"[dryrun] {res['arch']} {res['shape']}: skipped, or a "
                "collective term on an emulated mesh")
        m, r = res["memory"], res["roofline"]
        log(f"[dryrun] {res['arch']} {res['shape']} on {res['mesh']}: "
            f"per device argument {m['argument_bytes']} B, temp "
            f"{m['temp_bytes']} B, output {m['output_bytes']} B, alias "
            f"{m['alias_bytes']} B; {res['cost']['flops_per_device']:.4e} "
            f"FLOP and {res['cost']['bytes_per_device']:.4e} B per device; "
            f"model flops {r['model_flops_total']:.4e}, useful share "
            f"{r['useful_flops_ratio']:.3f}; {r['collective_note']}")
    for (arch, layers, fits), res in zip(DRYRUN_CARD, cells["card"]):
        m, r = res["memory"], res["roofline"]
        what = f"{arch} {'whole' if layers is None else f'{layers} layers'}"
        log(D.summary(res, f"{what} B={TRAIN_B} x {TRAIN_S} one card"))
        require(m["fits_hbm"] == fits,
                f"[dryrun] {what}: fits_hbm {m['fits_hbm']}, expected "
                f"{fits} ({m['hbm_used_bytes']} of {m['hbm_budget_bytes']} "
                "B)")
        meas = measured.get(arch)
        if meas is None or not fits:
            continue
        flops, peak = res["cost"]["flops_per_device"], m["hbm_used_bytes"]
        step_ms = meas["step_ms"]
        log(f"[dryrun] {what} predicted: {flops:.4e} FLOP per step, "
            f"step >= {r['step_time_lower_bound_s'] * 1e3:.3f} ms "
            f"({r['dominant']}: compute {r['compute_s'] * 1e3:.3f} ms, "
            f"memory {r['memory_s'] * 1e3:.3f} ms), peak {peak} B "
            f"(arguments {m['argument_bytes']}, temp {m['temp_bytes']}); "
            f"measured: {step_ms:.3f} ms per step, model flops "
            f"{meas['model_flops']:.4e} ({meas['model_flops_remat']:.4e} "
            f"with the remat forward), max_memory_allocated "
            f"{meas['peak_bytes']} B")
        log(f"[dryrun] {what} ratios: predicted / measured peak "
            f"{peak / meas['peak_bytes']:.4f}; counted / reckoned flops "
            f"{flops / meas['model_flops_remat']:.4f} (with remat), "
            f"{flops / meas['model_flops']:.4f} (without); lower bound / "
            f"measured step {r['step_time_lower_bound_s'] * 1e3 / step_ms:.4f}")


def ptxas_lines(report: str):
    """(function, line) for each register and spill line of an
    ``nvcc -Xptxas -v`` report; the function is the entry being compiled,
    shortened to its name and template arguments (the mangled form)."""
    import re
    fn = "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"([a-z_]+kernel)(I\w*?)?EE?v", m.group(1))
            fn = short.group(1) + (short.group(2) or "") if short else \
                m.group(1)
        elif "registers" in line or "spill" in line:
            yield fn, line.replace("ptxas info    :", "").strip()


def all_kernels():
    from repro_torch.kernels.derived_features.kernel import KERNEL as K5
    from repro_torch.kernels.flash_attention.bwd_kernel import KERNEL as K7
    from repro_torch.kernels.flash_attention.kernel import KERNEL as K6
    from repro_torch.kernels.flow_moments.kernel import KERNEL as K4
    from repro_torch.kernels.gather_enrich.kernel import KERNEL as K3
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2
    return (K1, K2, K3, K4, K5, K6, K7)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {smi}")
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    built = build.build([k.name for k in all_kernels()])
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for kname, (path, report) in built.items():
        for fn, line in ptxas_lines(report):
            log(f"[ptxas] {kname} {fn}: {line}")

    # 3. per-kernel checks at the paths' shapes
    clocks("kernel", "start")
    from repro_torch.configs import PAPER
    from repro_torch.data import packets as PK
    gen = torch.Generator().manual_seed(0)
    flows = PK.gen_flows(PAPER.flows_per_shard, seed=0)
    mem, valid = make_ring(PAPER, dev, gen)
    checks = [check_ingest(PAPER, dev, flows),
              check_ring_scatter(PAPER, dev, gen, mem, valid),
              check_gather_enrich(PAPER, dev, gen, mem, valid),
              check_flow_moments(PAPER, dev, flows, gen),
              check_derived_features(PAPER, dev, gen, mem, valid)]
    del mem, valid
    checks.append(check_flash_attention(dev))
    checks[-1]["mla"] = check_flash_attention_wide(dev)
    torch.cuda.empty_cache()
    checks.append(check_flash_attention_bwd(dev))
    torch.cuda.empty_cache()
    checks[-1]["mla"] = check_flash_attention_bwd_mla(dev)
    checks[-2]["zamba2"], checks[-1]["zamba2"] = \
        check_flash_attention_zamba2(dev)
    checks[-2]["whisper"], checks[-1]["whisper"] = \
        check_flash_attention_whisper(dev)
    checks[-2]["llava"], checks[-1]["llava"] = \
        check_flash_attention_llava(dev)
    for c in checks:
        log(f"[kernel] {c['kernel'].name} at {c['shape']}: {c['check']} ok; "
            f"kernel {c['ms']:.5f} ms, device {c['device_us']:.3f} us, "
            f"plain {c['plain_ms']:.5f} ms")
        if "gbps" in c:
            log(f"[kernel] {c['kernel'].name}: {c['gbps']:.1f} GB/s over "
                f"the device time, {100 * c['bound_share']:.1f} % of the "
                f"bound")
        if "atomics_counted" in c:
            n = c["atomics_counted"]
            log(f"[kernel] {c['kernel'].name}: {n} atomics per call, counted "
                f"from the inputs (not measured); "
                f"{n / (c['device_us'] * 1e3):.1f} G/s over the measured "
                f"device time")
        if "floor_us" in c:
            log(f"[kernel] {c['kernel'].name}: "
                f"{c['device_launches_per_call']:g} device launch(es) per "
                f"call; an empty kernel of the same launch shape takes "
                f"{c['floor_us']:.3f} us")
        if "distinct_device_us" in c:
            log(f"[kernel] {c['kernel'].name} on distinct ids: device "
                f"{c['distinct_device_us']:.3f} us, row-scaled err "
                f"{c['distinct_row_scaled_err']:.3e}")
        if "library_ms" in c:
            log(f"[kernel] {c['kernel'].name} library call: "
                f"{c['library_ms']:.5f} ms, device "
                f"{c['library_device_us']:.3f} us")
        if "simt_device_us" in c:
            log(f"[kernel] {c['kernel'].name} simt variant at the same "
                f"shape: {c['simt_ms']:.5f} ms, device "
                f"{c['simt_device_us']:.3f} us ({c['simt_note']})")
        if "whole_ring" in c:
            w = c["whole_ring"]
            log(f"[kernel] {c['kernel'].name} at {w['shape']}: kernel "
                f"{w['ms']:.5f} ms, device {w['device_us']:.3f} us, plain "
                f"{w['plain_ms']:.5f} ms, bound {w['bound_ms']:.5f} ms, "
                f"{w['gbps']:.1f} GB/s, {100 * w['bound_share']:.1f} % of "
                f"the bound")

    clocks("kernel", "end")

    # 4. main path (launch counts start at 0 here)
    system, events, nows = paper_system(dev)
    main_launches, v1_anomalies = phase("main", main_path, system, events,
                                        nows)

    # 4a. K1's event tile tuned on the main path's stream, recorded in a
    # tuning registry and consulted by one period
    phase("tune", tune_phase, dev, system, events, nows)

    # 5. unfused path (launch counts start at 0 again)
    unfused_launches = phase("unfused", unfused_path, system, events, nows)

    # 6.-9. the online serving slice at PAPER under V2: the V2 main path,
    # the overlapped driver, fault injection, the serving loop (launch
    # counts start at 0 again for the serving loop)
    phase("v2", v2_phase, dev, events, nows, v1_anomalies)
    phase("overlap", overlap_phase, dev, events, nows)
    phase("faults", faults_phase, dev, events, nows)

    # 9.-10. the emulated meshes (launch counts start at 0 for each)
    mesh1d_launches = phase("mesh1d", mesh1d_phase, dev)
    torch.cuda.empty_cache()
    mesh2d_launches, mesh_ev, mesh_nows = phase("mesh2d", mesh2d_phase, dev)
    host_ev = {k: v.cpu() for k, v in mesh_ev.items()}
    del mesh_ev
    torch.cuda.empty_cache()

    # 11. the serving loop (launch counts start at 0 again)
    serving_launches = phase("serving", serving_phase, dev, events, nows)
    del system, events, nows

    # 12.-13. the serving loop on the (2,2) mesh over [mesh2d]'s trace;
    # elastic pod loss and join (launch counts start at 0 for each)
    serving_mesh_launches = phase("serving mesh", serving_mesh_phase, dev,
                                  host_ev, mesh_nows)
    torch.cuda.empty_cache()
    elastic_launches = phase("elastic", elastic_phase, dev, host_ev,
                             mesh_nows)
    del host_ev
    torch.cuda.empty_cache()

    # 14. goldens
    phase("golden", golden, dev)

    # the dry run's host work, on meta tensors in a process of its own
    # beside the model phases; [dryrun] reads it after the training phases
    dry = DryrunJob()

    # 15. serving at full width (launch counts start at 0 again)
    serve_launches, serve_variants = phase("serve", serve_phase, dev)
    torch.cuda.empty_cache()

    # 16.-18. deepseek-v3 (MLA + MoE), qwen3-14b and zamba2-2.7b (hybrid)
    # serving (launch counts start at 0 again for each)
    deepseek_launches, deepseek_variants = phase(
        "serve deepseek-v3", serve_deepseek_phase, dev)
    qwen_launches, qwen_variants = phase("serve qwen3-14b",
                                         serve_qwen_phase, dev)
    zamba_launches, zamba_variants = phase("serve zamba2-2.7b",
                                           serve_zamba2_phase, dev)
    # rwkv6-3b (ssm, no attention) and whisper-tiny (encdec: K6 without a
    # mask in the encoder) serving (launch counts start at 0 for each)
    rwkv_launches, rwkv_variants = phase("serve rwkv6-3b", serve_rwkv_phase,
                                         dev)
    whisper_launches, whisper_variants, whisper_kinds = phase(
        "serve whisper-tiny", serve_whisper_phase, dev)
    # llava-next-mistral-7b (vlm: 2880 patches before each prompt)
    llava_launches, llava_variants, llava_kinds = phase(
        "serve llava-next-mistral-7b", serve_llava_phase, dev)
    k6_row = next(c for c in checks if c["kernel"].name == "flash_attention")
    k6_row["variants_by_path"] = {"serve": serve_variants,
                                  "serve_deepseek": deepseek_variants,
                                  "serve_qwen": qwen_variants,
                                  "serve_zamba2": zamba_variants,
                                  "serve_rwkv": rwkv_variants,
                                  "serve_whisper": whisper_variants,
                                  "serve_llava": llava_variants}
    k7_row = next(c for c in checks
                  if c["kernel"].name == "flash_attention_bwd")

    # 19.-22. training at full width: granite-3-2b, deepseek-v3's dense
    # layers, a llama4-scout MoE layer, zamba2-2.7b (launch counts start at
    # 0 again for each); 23. steps against the plain versions and f32;
    # 24. the examples
    train_launches, train_variants, _, train_measured = \
        phase("train", train_phase, dev)
    train_ds_launches, train_ds_variants, _, _ = \
        phase("train deepseek-v3", train_deepseek_phase, dev)
    train_l4_launches, train_l4_variants, _, _ = \
        phase("train llama4-scout", train_llama4_phase, dev)
    train_z_launches, train_z_variants, _, _ = \
        phase("train zamba2-2.7b", train_zamba2_phase, dev)
    train_r_launches, train_r_variants, _, _ = \
        phase("train rwkv6-3b", train_rwkv_phase, dev)
    train_w_launches, train_w_variants, train_w_kinds, _ = \
        phase("train whisper-tiny", train_whisper_phase, dev)
    train_v_launches, train_v_variants, train_v_kinds, llava_measured = \
        phase("train llava-next-mistral-7b", train_llava_phase, dev)
    k7_row["variants_by_path"] = {"train": train_variants,
                                  "train_deepseek": train_ds_variants,
                                  "train_llama4": train_l4_variants,
                                  "train_zamba2": train_z_variants,
                                  "train_rwkv": train_r_variants,
                                  "train_whisper": train_w_variants,
                                  "train_llava": train_v_variants}
    k6_row["kinds_by_path"] = {
        "serve_whisper": whisper_kinds,
        "train_whisper": train_w_kinds["flash_attention"],
        "serve_llava": llava_kinds,
        "train_llava": train_v_kinds["flash_attention"]}
    k7_row["kinds_by_path"] = {
        "train_whisper": train_w_kinds["flash_attention_bwd"],
        "train_llava": train_v_kinds["flash_attention_bwd"]}
    # 22d. the dry run against the training phases just measured
    phase("dryrun", dryrun_phase, dry, {"granite-3-2b": train_measured,
                                        "llava-next-mistral-7b":
                                        llava_measured})
    phase("train check", train_check_phase, dev)
    phase("examples", examples_phase, dev)

    print(json.dumps({"kernels": kernel_rows(
        checks, {"main": main_launches, "unfused": unfused_launches,
                 "serving": serving_launches, "mesh1d": mesh1d_launches,
                 "mesh2d": mesh2d_launches,
                 "serving_mesh": serving_mesh_launches,
                 "elastic": elastic_launches, "serve": serve_launches,
                 "serve_deepseek": deepseek_launches,
                 "serve_qwen": qwen_launches,
                 "serve_zamba2": zamba_launches,
                 "serve_rwkv": rwkv_launches,
                 "serve_whisper": whisper_launches,
                 "serve_llava": llava_launches, "train": train_launches,
                 "train_deepseek": train_ds_launches,
                 "train_llama4": train_l4_launches,
                 "train_zamba2": train_z_launches,
                 "train_rwkv": train_r_launches,
                 "train_whisper": train_w_launches,
                 "train_llava": train_v_launches},
        {"flash_attention": serve_variants,
         "flash_attention_bwd": train_variants})}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


def kernel_rows(checks, by_path, by_variant):
    """One row of the ``{"kernels": [...]}`` line per checked kernel;
    ``launches`` comes from the first path in ``by_path`` (path name ->
    {kernel name: launches}) that launched the kernel; ``by_variant``
    holds the per-variant counts of that run for kernels that have
    variants."""
    rows = []
    for c in checks:
        k = c["kernel"]
        b_ms, b_by = bound(c["n_bytes"], c["n_ops"],
                           c.get("ops_per_s", F32_OPS_PER_S))
        counted = {p: n[k.name] for p, n in by_path.items() if k.name in n}
        path = next((p for p, n in counted.items() if n),
                    next(iter(counted)))
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": counted[path],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by,
                     "library_ms": c.get("library_ms"),
                     "library_device_us": c.get("library_device_us"),
                     "library_note": c.get(
                         "library_note", "no single PyTorch call computes "
                                         "this function"),
                     "launches_path": path, "launches_by_path": counted,
                     "device_us": c["device_us"],
                     # the same numbers in µs, under the names PERF.md uses
                     "kernel_us": c["ms"] * 1e3,
                     "plain_us": c["plain_ms"] * 1e3,
                     "bound_us": b_ms * 1e3,
                     "library_us": (None if c.get("library_ms") is None
                                    else c["library_ms"] * 1e3),
                     "max_err": c["max_abs_err"],
                     "shape": c["shape"], "check": c["check"],
                     **({"launches_by_variant": by_variant[k.name]}
                        if k.name in by_variant else {}),
                     **{key: c[key] for key in (
                         "row_scaled_err", "whole_ring", "errs", "variant",
                         "gbps", "bound_share", "redesigned",
                         "device_launches_per_call",
                         "floor_us",
                         "distinct_device_us", "distinct_row_scaled_err",
                         "variants", "simt_device_us", "simt_ms",
                         "simt_note", "abs_errs", "lse_errs", "mla",
                         "zamba2", "whisper", "llava", "variants_by_path",
                         "kinds_by_path")
                        if key in c}})
    return rows


if __name__ == "__main__":
    sys.exit(main())
