"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``; its configuration's file
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``,
whose ``entry`` names the driver in :mod:`drivers`), its limits
(``limits/<cell>.json``), and one reader per metric
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or None).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result (no card, a missing piece)."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_spec(cell: str, root: Path = ROOT) -> SimpleNamespace:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise Refused(f"no workload {cell!r} in BENCHMARK.json; known: "
                      f"{sorted(cells)}")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell])]
    end_to_end = [m for m in bench["end_to_end"]
                  if cell in m.get("workloads", [cell])]
    return SimpleNamespace(
        cell=cell, chips=int(w["chips"]), workload=w,
        config=load_json(root / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{cell}.json"),
        end_to_end=end_to_end, per_layer=per_layer)


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def make_head(cfg, seed: int, device):
    """The head's weights, drawn on the device from the seed."""
    import torch
    if cfg.inference_head == "none":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    D, Hd, C = cfg.derived_dim, cfg.inference_hidden, cfg.inference_classes
    shapes = ({"w": (D, C), "b": (C,)} if cfg.inference_head == "linear"
              else {"w1": (D, Hd), "b1": (Hd,), "w2": (Hd, C), "b2": (C,)})
    return {k: 0.1 * torch.randn(s, generator=g, device=device)
            for k, s in shapes.items()}


def build_system(spec, device):
    import dataclasses

    import torch
    from repro_torch.configs.base import DFAConfig
    from repro_torch.core.pipeline import DFASystem
    names = {f.name for f in dataclasses.fields(DFAConfig)}
    fields = spec.config["dfa"]
    unknown = set(fields) - names
    if unknown:
        raise Refused(f"configuration fields the program lacks: "
                      f"{sorted(unknown)}")
    cfg = DFAConfig(**fields)
    system = DFASystem(cfg, device=device,
                       n_shards=int(spec.config["n_shards"]))
    return cfg, system


def touched_slots(trace, ref_cfg, n_ports: int) -> "list":
    """Per trace period, the distinct reporter slots its events touch,
    summed over the ports (the reference's hash)."""
    from bench.reference import reporter as RREP
    slots_per_port = ref_cfg.reporter_slots or ref_cfg.flows_per_shard
    T, N = trace["ts"].shape
    E = N // n_ports
    out = []
    for t in range(T):
        n = 0
        for p in range(n_ports):
            sl = slice(p * E, (p + 1) * E)
            s = RREP.hash_slot(trace["five_tuple"][t, sl], slots_per_port)
            n += int(s[trace["valid"][t, sl]].unique().numel())
        out.append(n)
    return out


def compare(driver, spec, seed: int, device, head) -> Tuple[Dict, int, list,
                                                          float]:
    """Replay every period through the reference and compare; returns
    (readings, failed periods, touched slots per trace period, the share
    of masked rows ``logit_gap`` left out)."""
    import torch
    from bench import check, traffic
    from bench.reference.config import from_fields
    from bench.reference.period import RefSystem
    ref_cfg = from_fields(spec.config["dfa"])
    n = int(spec.config["n_shards"])
    ref = RefSystem(ref_cfg, n, head=head, device=device)
    trace, nows = traffic.make_trace(spec.mix, ref.total_ports, seed, device)
    nows = nows.cpu()
    K = driver.periods
    prog = {m: driver.period_metrics(m) for m in check.METRIC_KEYS}
    cmp = check.Comparison(K, device, head)
    state = ref.init_state()
    with torch.no_grad():
        for k in range(K):
            ev, now = driver.inputs(k, trace, nows)
            state, out = ref.step(state, ev, now, k in driver.sampled)
            cmp.metrics(k, {m: prog[m][k] for m in prog}, out.metrics)
            if k in driver.sampled:
                cmp.outputs(k, driver.sampled[k], out, spec.limits)
        cmp.state(driver.state, state)
    touched = touched_slots(trace, ref_cfg, ref.total_ports)
    return cmp.readings(), cmp.failed_periods(), touched, \
        cmp.left_out_share()


def run(cell: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: Optional[str] = None,
        check_chips: bool = True, spec=None) -> Tuple[dict, List[str]]:
    """One run; returns (result line, check lines). Raises Refused where
    no result may be printed. ``device``, ``check_chips`` and ``spec``
    (a :func:`cell_spec` made elsewhere) let the tests drive a run on the
    CPU at a small size."""
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[k]          # run the configuration as it states
    spec = spec or cell_spec(cell)
    import torch
    if check_chips:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < spec.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {spec.chips}")
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    from bench import drivers, traffic
    from bench.trace import TraceSummary, profiled, spans_on
    torch.manual_seed(int(seed))
    random.seed(int(seed))

    with torch.no_grad():
        cfg, system = build_system(spec, dev)
        head = make_head(cfg, seed, dev)
        if head is not None:
            for k, v in head.items():
                getattr(system.head, k).copy_(v)
        events, nows = traffic.make_trace(spec.mix, system.total_ports, seed,
                                          dev)
        driver = drivers.ENTRIES[spec.mix["entry"]](system, spec.mix, events,
                                                    nows, seed)
        del events
        driver.warm()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        driver.window(seconds)
        setup_s = driver.t_start - t_start
        # the traced periods, after the measured window: the card's own
        # time for the end-to-end metric, and with --trace 1 the spans
        with spans_on(system) if trace else contextlib.nullcontext():
            summary = TraceSummary(profiled(driver.traced, on_card))
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ports = system.total_ports
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the benchmark may not load: "
                      f"{found}")
    vectors = int(driver.vectors)
    traced_vectors = int(driver.traced_vectors)
    # the program's state, counters and sampled outputs stay; the rest goes
    driver.system = driver.loop = driver.events = None
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings, failed, touched, left_out = compare(driver, spec, seed, dev,
                                                  head)
    timing = {"setup_s": setup_s, "window_s": driver.window_s,
              "reference_s": time.perf_counter() - t_ref,
              "periods": driver.periods,
              "logit_rows_left_out": left_out,
              "vectors_per_s_by_tenth": driver.profile()}
    from bench import check
    correct = check.verdict(readings, spec.limits)

    # what a metric reader may read: the cell's spec and DFAConfig, the
    # driver (window, host splits, per-period counters, sampled outputs),
    # set-up seconds, vectors delivered in the measured window and in the
    # traced periods, the traced periods' TraceSummary, touched slots per
    # trace period, ports
    ctx = SimpleNamespace(cell=cell, spec=spec, cfg=cfg, driver=driver,
                          setup_s=setup_s, vectors=vectors,
                          traced_vectors=traced_vectors, trace=summary,
                          touched=touched, ports=ports)
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": spec.chips if on_card else 0,
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if on_card else None,
    }
    result = {"correct": bool(correct), "attempted": driver.periods,
              "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_us * 1e-6
        device_info["window_s"] = summary.window_us * 1e-6
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = check.as_result(readings, spec.limits)
    print(f"timing {json.dumps(timing)}", file=sys.stderr)
    return result, check.report_lines(readings, spec.limits)
