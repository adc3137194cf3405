#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing is caught):

1. device — the card's name, count, power limit; TF32 off;
2. build — the three CUDA kernels from src/repro_torch/csrc, one nvcc per
   source in parallel, into build/repro_torch_kernels/ (ptxas report:
   registers and spills);
3. per-kernel check at PAPER shapes — each kernel against its plain
   PyTorch version on the same inputs on the card (integers bit for bit,
   features within 1e-5 of each row's feature scale), timed with CUDA
   events in turns (plain, kernel, kernel, plain) beside its bound;
4. main path at the paper's size — DFASystem on the PAPER config
   (2^17 flows, 10-entry ring, 4096 reports/period) with an mlp head,
   2^20 packet events per 20 ms period from a 131,072-flow trace: one
   warm-up and 8 timed periods with every kernel launch counted, then
   the same periods on the plain versions (backend="ref"), which must
   give the same integer state bit for bit and the same features;
5. golden — the REDUCED T=4 run reproduces tests/goldens/run_periods_t4.json.

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
T_MAIN = 8                   # timed main-path periods (after one warm-up)
EVENTS = 1 << 20             # packet events per period on the main path
FEATURE_TOL = 1e-5           # row-scaled feature tolerance
PRED_TOL = 1e-5              # head outputs, kernel run vs plain run


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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
    pays = torch.randint(-(1 << 31), (1 << 31) - 1, (R, 16), generator=gen,
                         dtype=torch.int32).to(dev)
    cases = {
        # the main path's shape: distinct flows (due flows are unique)
        "distinct": (torch.randperm(F, generator=gen)[:R],
                     torch.randint(0, H, (R,), generator=gen)),
        # many rows per (flow, hist) cell: last write must win
        "duplicates": (torch.randint(0, 256, (R,), generator=gen),
                       torch.randint(0, 2, (R,), generator=gen)),
    }
    mask = (torch.rand(R, generator=gen) < 0.95).to(dev)
    err = 0
    for flow, hist in cases.values():
        flow, hist = flow.to(dev), hist.to(dev)
        mk, vk = mem0.clone(), ev0.clone()
        mr, vr = mem0.clone(), ev0.clone()
        ops.ring_scatter(mk, vk, pays, flow, hist, mask)
        ops.ring_scatter(mr, vr, pays, flow, hist, mask, backend="ref")
        torch.cuda.synchronize()
        require(torch.equal(mk, mr) and torch.equal(vk, vr),
                "ring_scatter differs from its plain version")
        require(not torch.equal(mk, mem0), "ring_scatter wrote nothing")
        err = max(err, int((mk.long() - mr.long()).abs().max()))
    flow, hist = (t.to(dev) for t in cases["distinct"])
    mk, vk = mem0.clone(), ev0.clone()
    ms, plain_ms = in_turns(
        lambda: ops.ring_scatter(mk, vk, pays, flow, hist, mask,
                                 backend="ref"),
        lambda: ops.ring_scatter(mk, vk, pays, flow, hist, mask), 50)
    cells = flow.long() * H + hist.long()
    winners = int(torch.unique(cells[mask]).numel())
    # each row's payload + coords + mask read once; each winning cell's
    # 64 B entry and validity byte written once
    n_bytes = R * (64 + 4 + 4 + 1) + winners * (64 + 1)
    return {"kernel": K.KERNEL, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "n_bytes": n_bytes, "n_ops": 0,
            "shape": f"R={R} into ({F}, {H}, 16), distinct cells "
                     "(duplicate-cell batch checked too)",
            "check": "bitwise"}


def check_gather_enrich(cfg, dev, gen, mem, valid):
    import torch
    from repro_torch.kernels.gather_enrich import kernel as K
    from repro_torch.kernels.gather_enrich import ops

    F, H, R, D = (cfg.flows_per_shard, cfg.history, cfg.report_capacity,
                  cfg.derived_dim)
    lf = torch.randint(0, F, (R,), generator=gen).to(dev)
    got = ops.gather_enrich(mem, valid, lf, cfg)
    want = ops.gather_enrich(mem, valid, lf, cfg, backend="ref")
    torch.cuda.synchronize()
    scaled = feature_err(got, want)
    require(bool(torch.isfinite(got).all()), "gather_enrich: non-finite")
    require(scaled <= FEATURE_TOL, f"gather_enrich differs from its plain "
                                   f"version: row-scaled err {scaled:.3e}")
    ms, plain_ms = in_turns(
        lambda: ops.gather_enrich(mem, valid, lf, cfg, backend="ref"),
        lambda: ops.gather_enrich(mem, valid, lf, cfg), 50)
    rows = int(torch.unique(lf).numel())
    # each gathered flow's H entries + validity read once, ids read, the
    # (R, D) f32 features written; ~100 flops per entry (18 features,
    # window sums, the two-pass variance) plus ~100 per row
    n_bytes = rows * H * (64 + 1) + R * 4 + R * D * 4
    n_ops = R * (H * 100 + 100)
    return {"kernel": K.KERNEL,
            "max_abs_err": float((got - want).abs().max()),
            "row_scaled_err": scaled, "ms": ms, "plain_ms": plain_ms,
            "n_bytes": n_bytes, "n_ops": n_ops,
            "shape": f"R={R} from ({F}, {H}, 16), D={D}",
            "check": f"row-scaled {FEATURE_TOL:g}"}


# -- phase 4: the main path ---------------------------------------------------

def main_path(dev):
    import torch
    from repro_torch.configs import PAPER
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK

    cfg = dataclasses.replace(PAPER, inference_head="mlp")
    rng = np.random.default_rng(0)
    D, Hd, C = cfg.derived_dim, cfg.inference_hidden, cfg.inference_classes
    params = {"w1": 0.1 * rng.standard_normal((D, Hd), np.float32),
              "b1": np.zeros(Hd, np.float32),
              "w2": 0.1 * rng.standard_normal((Hd, C), np.float32),
              "b2": np.zeros(C, np.float32)}
    system = DFASystem(cfg, device=dev, infer_params=params)
    t0 = time.perf_counter()
    events, nows = PK.period_batches(
        1, T_MAIN + 1, EVENTS, n_flows=cfg.flows_per_shard, flow_seed=0,
        period_us=cfg.monitoring_period_us,
        window_us=cfg.monitoring_period_us, device=dev)
    torch.cuda.synchronize()
    log(f"[main] traffic: {T_MAIN + 1} periods x {EVENTS} events from "
        f"{cfg.flows_per_shard} flows, made in "
        f"{time.perf_counter() - t0:.3f} s")

    def run(backend):
        state = system.init_state()
        outs, period_ms = [], []
        torch.cuda.synchronize()
        for t in range(T_MAIN + 1):
            t0 = time.perf_counter()
            out = system.dfa_step(state, {k: v[t] for k, v in events.items()},
                                  nows[t], backend=backend)
            torch.cuda.synchronize()
            period_ms.append((time.perf_counter() - t0) * 1e3)
            state = out.state
            outs.append(out)
        return state, outs, period_ms

    from repro_torch.kernels.gather_enrich.kernel import KERNEL as K3
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2
    kernels = (K1, K2, K3)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    state, outs, period_ms = run(None)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        require(launches[k.name] >= T_MAIN,
                f"{k.name} launched {launches[k.name]} times on the main "
                f"path, expected >= {T_MAIN}")
    for t, out in enumerate(outs):
        m = {k: int(v) for k, v in out.metrics.items()}
        require(m["reports_sent"] == m["reports_recv"],
                f"period {t}: sent {m['reports_sent']} != recv "
                f"{m['reports_recv']}")
        require(m["bad_checksum"] == 0, f"period {t}: bad checksums")
        require(out.enriched.shape == (cfg.report_capacity, D)
                and bool(torch.isfinite(out.enriched).all()),
                f"period {t}: features not finite / wrong shape")
        require(out.preds.shape == (cfg.report_capacity, C)
                and bool(torch.isfinite(out.preds).all()),
                f"period {t}: preds not finite / wrong shape")
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

    profile_periods(system, events, nows)

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
    worst, worst_pred = 0.0, 0.0
    for t, (o, r) in enumerate(zip(outs, ref_outs)):
        require(torch.equal(o.flow_ids, r.flow_ids)
                and torch.equal(o.mask, r.mask),
                f"period {t}: routed flows differ from the plain run")
        for k in o.metrics:
            require(int(o.metrics[k]) == int(r.metrics[k]),
                    f"period {t}: metric {k} differs from the plain run")
        worst = max(worst, feature_err(o.enriched, r.enriched))
        worst_pred = max(worst_pred, float((o.preds - r.preds).abs().max()))
        require(torch.allclose(o.preds, r.preds, rtol=PRED_TOL,
                               atol=PRED_TOL),
                f"period {t}: preds differ from the plain run")
    require(worst <= FEATURE_TOL,
            f"features differ from the plain run: row-scaled {worst:.3e}")
    log(f"[main] kernel run == plain run: integer state bitwise, features "
        f"row-scaled err {worst:.3e}, preds max abs err {worst_pred:.3e} "
        f"(tolerance rtol=atol={PRED_TOL:g})")
    return launches


def profile_periods(system, events, nows, periods: int = 2):
    """torch.profiler over ``periods`` steady main-path periods: device
    time by kernel name (top 15) and the device's busy share of the wall
    time. Runs after the launch counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = system.init_state()
    out = system.dfa_step(state, {k: v[0] for k, v in events.items()},
                          nows[0])
    torch.cuda.synchronize()
    state = out.state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, periods + 1):
            state = system.dfa_step(state, {k: v[t] for k, v in
                                            events.items()}, nows[t]).state
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # device-side events only: an aten op's own entry repeats the time
    # of the kernels it launched
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    log(f"[profile] {periods} periods: wall {wall_us:.1f} us, device busy "
        f"{busy_us:.1f} us ({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 - 100 * busy_us / wall_us:.1f} %")
    launches = sum(e.count for e in rows) / periods
    log(f"[profile] device kernels per period: {launches:.0f}")
    for e in rows[:15]:
        log(f"[profile]   {dev_us(e) / periods:10.1f} us/period  "
            f"{e.count // periods:5d} calls/period  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in host)
    log(f"[profile] host self time per period {host_us / periods:.1f} us "
        "(profiler overhead included); top ops:")
    for e in host[:10]:
        log(f"[profile]   {e.self_cpu_time_total / periods:10.1f} us/period"
            f"  {e.count // periods:5d} calls/period  {e.key[:60]}")


# -- phase 5: golden ------------------------------------------------------------

def golden(dev):
    from repro_torch.configs import REDUCED
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.pipeline import DFASystem
    from repro_torch.data import packets as PK

    want = json.loads(GOLDEN.read_text())
    T = want["T"]
    system = DFASystem(REDUCED, device=dev)
    events, nows = PK.period_batches(1, T, want["events_per_shard"],
                                     n_flows=10, flow_seed=3, device=dev)
    out = system.run_periods(system.init_state(), events, nows)
    st = state_to_numpy(out.state)
    enr, fid = out.enriched.cpu().numpy(), out.flow_ids.cpu().numpy()
    em = out.mask.cpu().numpy()
    require(int(st.collector.received.astype(np.uint64).sum())
            == want["collector_received"], "golden: collector_received")
    require(int(st.collector.entry_valid.sum()) == want["entry_valid_count"],
            "golden: entry_valid_count")
    require(int(np.bitwise_xor.reduce(st.reporter.regs.reshape(-1)))
            == want["regs_checksum"], "golden: regs_checksum")
    for t, w in enumerate(want["periods"]):
        rows = em[t]
        e = enr[t][rows].astype(np.float64)
        require(int(rows.sum()) == w["received"], f"golden {t}: received")
        require(sorted(int(x) for x in fid[t][rows]) == w["flow_ids"],
                f"golden {t}: flow_ids")
        for k, v in w["metrics"].items():
            require(int(out.metrics[k][t]) == v, f"golden {t}: {k}")
        np.testing.assert_allclose(e.sum(), w["enriched_sum"], rtol=1e-4)
        np.testing.assert_allclose(np.abs(e).mean(), w["enriched_abs_mean"],
                                   rtol=1e-4)
        np.testing.assert_allclose(np.sort(e, axis=0)[0][:8],
                                   w["first_row_head"], rtol=1e-4, atol=1e-6)
    log(f"[golden] REDUCED T={T} reproduces {GOLDEN.relative_to(ROOT)}")


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
    from repro_torch.kernels.gather_enrich.kernel import KERNEL as K3
    from repro_torch.kernels.ingest_update.kernel import KERNEL as K1
    from repro_torch.kernels.ring_scatter.kernel import KERNEL as K2
    t0 = time.perf_counter()
    built = build.build([k.name for k in (K1, K2, K3)])
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for kname, (path, report) in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {kname}: {line.strip()}")

    # 3. per-kernel checks at PAPER shapes
    from repro_torch.configs import PAPER
    from repro_torch.data import packets as PK
    gen = torch.Generator().manual_seed(0)
    flows = PK.gen_flows(PAPER.flows_per_shard, seed=0)
    mem, valid = make_ring(PAPER, dev, gen)
    checks = [check_ingest(PAPER, dev, flows),
              check_ring_scatter(PAPER, dev, gen, mem, valid),
              check_gather_enrich(PAPER, dev, gen, mem, valid)]
    for c in checks:
        log(f"[kernel] {c['kernel'].name} at {c['shape']}: {c['check']} ok; "
            f"kernel {c['ms']:.5f} ms, plain {c['plain_ms']:.5f} ms")

    # 4. main path (launch counts start at 0 here)
    launches = main_path(dev)

    # 5. golden
    golden(dev)

    rows = []
    for c in checks:
        k = c["kernel"]
        b_ms, b_by = bound(c["n_bytes"], c["n_ops"])
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "library_note": "no single PyTorch call computes this "
                                     "function",
                     # the same numbers in µs, under the names PERF.md uses
                     "kernel_us": c["ms"] * 1e3,
                     "plain_us": c["plain_ms"] * 1e3,
                     "bound_us": b_ms * 1e3, "library_us": None,
                     "max_err": c["max_abs_err"],
                     "shape": c["shape"], "check": c["check"],
                     **({"row_scaled_err": c["row_scaled_err"]}
                        if "row_scaled_err" in c else {})})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
