"""Dry run: is a (architecture x input shape x mesh) cell coherent, what
does its step cost, and does it fit the card? (The port of
``repro.launch.dryrun``.)

For every cell this builds the state and the inputs as ``meta`` tensors
(no storage: the counterpart of the reference's ``ShapeDtypeStruct``
stand-ins), runs the train, prefill or decode step once on them under
``launch.op_analysis`` and records:

  * memory — per-device argument, output and alias bytes, exact from each
    leaf's partition spec (``models.param.LogicalRules``) over the mesh,
    and temp bytes from the step's counted peak of live bytes (split
    evenly over the devices) against the card's HBM;
  * cost — the counted product FLOPs and op bytes, split evenly over the
    devices;
  * the roofline's compute and memory terms and the dominant one.

Every mesh of the port is emulated on one device, so a step issues no
collective: ``collective_s`` is ``null``, and the JSON says why. On
``meta`` every kernel wrapper runs its plain version (as on the CPU), so
the counts are those of the plain program: the plain attention's score
chunks count where K6 / K7 keep their tiles on chip. Nothing is
allocated on the card and no kernel is launched.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (SHAPES, get_config, get_shape, list_archs,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import EmulatedMesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import param as PM
from repro_torch.models.registry import (Model, decode_axes, input_specs,
                                         train_batch_axes)

# ---- hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet) ---------
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_DATASHEET_BYTES = 80 * 10 ** 9

COLLECTIVE_NOTE = ("every mesh of the port is emulated on one device "
                   "(launch.mesh.EmulatedMesh), so the step issues no "
                   "collective and there is no link to time")
NOTES = {
    "temp_bytes": "the step's counted peak of live bytes less the "
                  "arguments and the outputs they do not alias, split "
                  "evenly over the devices",
    "cost": "product FLOPs and op bytes counted over the eager aten ops "
            "(launch.op_analysis), split evenly over the devices; the "
            "bytes are the unfused eager program's",
    "compile_seconds": "the seconds to trace the step on meta tensors",
    "cpu_f32_artifact_bytes": "bytes of the f32 tensor shapes the step "
                              "creates with a bf16 tensor's shape: the "
                              "step's own widening, no compiler artifact",
    "plain_versions": "on meta every kernel wrapper runs its plain "
                      "version: the plain attention's chunks count where "
                      "K6 / K7 keep their tiles on chip",
}


def hbm_budget() -> Tuple[int, str]:
    """(bytes, source): the card's total memory when one is present, else
    the H100 SXM 80GB data sheet's."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"{props.name} total_memory"
    return HBM_DATASHEET_BYTES, "H100 SXM 80GB data sheet"


def count_active_params(model: Model) -> Tuple[int, int]:
    """(total, active) parameter counts (MoE: top_k/num_experts of experts)."""
    cfg = model.cfg
    total = active = 0
    for path, d in PM.leaf_paths(model.param_descs()):
        n = int(np.prod(d.shape))
        total += n
        if (cfg.moe is not None and "moe" in path
                and d.shape and d.shape[-0] == cfg.moe.num_experts
                and len(d.shape) >= 3):
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape, n_active: int) -> float:
    """'Useful' model FLOPs for the step (the 6ND / 2ND convention)."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch          # decode: 1 tok/seq


def _sharded_bytes(tensors, specs, sizes: Dict[str, int]) -> int:
    """Per-device bytes of ``tensors`` laid out by ``specs`` (two trees of
    the same structure; a leaf spec ``()`` is replicated)."""
    ts, _ = torch.utils._pytree.tree_flatten(tensors)
    ss, _ = torch.utils._pytree.tree_flatten(
        specs, is_leaf=lambda x: type(x) is tuple)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} tensors against {len(ss)} specs")
    return sum(math.prod(PM.shard_shape(tuple(t.shape), s, sizes))
               * t.element_size() for t, s in zip(ts, ss))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: EmulatedMesh
               ) -> Dict[str, Any]:
    """Build the cell's state and inputs on ``meta`` and run its step once
    under ``OpAnalysis``: the counts plus the per-device argument,
    output and alias bytes from the specs. Train: ``make_train_step``
    (the loss and gradients, remat as the config has it, and the AdamW
    update in place); prefill: ``Model.prefill``; decode:
    ``Model.decode`` over the meta cache."""
    model = Model(cfg, device="meta")
    sizes = mesh.shape
    B, S = shape.global_batch, shape.seq_len
    batch, bspecs = input_specs(cfg, shape, mesh)
    arg_b = _sharded_bytes(batch, bspecs, sizes)
    t0 = time.perf_counter()
    if shape.kind == "train":
        tcfg = TrainConfig()
        state = ST.abstract_train_state(model, tcfg)
        sspecs = ST.train_state_specs(model, tcfg, mesh)
        state_b = _sharded_bytes(state, sspecs, sizes)
        step = ST.make_train_step(model, tcfg)
        with OpAnalysis((state, batch)) as oa:
            _, metrics = step(state, batch)
        arg_b += state_b
        out_b = state_b + sum(4 for _ in metrics)     # f32 0-d metrics
        alias_b = state_b if tcfg.donate_state else 0
    elif shape.kind == "prefill":
        params = model.abstract_params()
        arg_b += _sharded_bytes(params, model.param_specs(mesh), sizes)
        with OpAnalysis((params, batch)) as oa:
            logits, _ = model.prefill(params, batch)
        cache = PM.abstract(model.cache_descs(B, S))
        baxes = train_batch_axes(mesh, B) or None
        out_b = (_sharded_bytes(logits, (baxes,) + (None,) * (logits.dim()
                                                              - 1), sizes)
                 + _sharded_bytes(cache, ST.cache_specs(model, mesh, B, S),
                                  sizes))
        alias_b = 0
    else:
        params = model.abstract_params()
        cache = PM.abstract(model.cache_descs(B, S))
        cache_b = _sharded_bytes(cache, ST.cache_specs(model, mesh, B, S),
                                 sizes)
        arg_b += (_sharded_bytes(params, ST.serve_param_specs(model, mesh, B),
                                 sizes) + cache_b)
        with OpAnalysis((params, batch, cache)) as oa:
            logits, _ = model.decode(params, batch["token"], batch["pos"],
                                     cache)
        baxes, _ = decode_axes(mesh, B, S)
        out_b = cache_b + _sharded_bytes(
            logits, (baxes or None,) + (None,) * (logits.dim() - 1), sizes)
        alias_b = cache_b
    trace_s = time.perf_counter() - t0
    return {**oa.result(), "argument_bytes": int(arg_b),
            "output_bytes": int(out_b), "alias_bytes": int(alias_b),
            "trace_seconds": trace_s}


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh: EmulatedMesh,
            meta: Dict[str, Any], hbm: Optional[Tuple[int, str]] = None
            ) -> Dict[str, Any]:
    """The reference's ``analyze`` keys for one traced cell; ``hbm``
    (bytes, source) overrides :func:`hbm_budget`."""
    c = trace_cell(cfg, shape, mesh)
    n_dev = meta["devices"]
    flops_dev = c["flops"] / n_dev
    bytes_dev = c["bytes"] / n_dev
    arg, out, alias = c["argument_bytes"], c["output_bytes"], \
        c["alias_bytes"]
    # the peak counts the whole step on one device: the arguments, the
    # outputs and the temporaries; the temporaries are what is left
    temp = max(c["peak_live_bytes"] - n_dev * (arg + max(out - alias, 0)),
               0) // n_dev
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    mf = model_flops(cfg, shape, meta["params_active"])
    hbm_used = int(arg + temp + out - alias)
    budget, budget_src = hbm or hbm_budget()
    return {
        **meta,
        "compile_seconds": round(c["trace_seconds"], 1),
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(out),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias),
            "hbm_used_bytes": hbm_used,
            "hbm_budget_bytes": budget,
            "hbm_budget_source": budget_src,
            "fits_hbm": bool(hbm_used <= budget),
            "cpu_f32_artifact_bytes": int(c["f32_artifact_bytes"]),
            "fits_hbm_tpu_adjusted": None,
            "peak_live_bytes": int(c["peak_live_bytes"]),
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev,
                 "xla_cost_analysis_flops": None,
                 "xla_cost_analysis_bytes": None,
                 "ops": c["ops"]},
        "collectives": {"bytes_per_kind": c["collective_bytes"],
                        "counts": c["collective_counts"],
                        "total": c["collective_total"]},
        "roofline": {
            **terms,
            "collective_s": None,
            "collective_note": COLLECTIVE_NOTE,
            "dominant": dominant,
            "step_time_lower_bound_s": bound_s,
            "model_flops_total": mf,
            "hlo_flops_total": c["flops"],
            "useful_flops_ratio": mf / c["flops"] if c["flops"] else 0.0,
            "roofline_fraction": (mf / n_dev / PEAK_FLOPS)
            / max(bound_s, 1e-12),
        },
        "notes": NOTES,
    }


def mesh_tag(mesh: EmulatedMesh, multi_pod: bool, production: bool) -> str:
    if production:
        return "pod2" if multi_pod else "pod1"
    return "mesh" + "x".join(str(s) for s in mesh.axis_sizes)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh: Optional[EmulatedMesh] = None,
             hbm: Optional[Tuple[int, str]] = None) -> Dict[str, Any]:
    """One cell: ``arch`` at ``shape_name`` on the production mesh (16 x
    16, or 2 x 16 x 16 under ``multi_pod``), written to
    ``out_dir/<arch>__<shape>__<pod1|pod2>.json``. ``cfg``, ``shape`` and
    ``mesh`` override the config (a layer cut: the file's name then ends
    in ``__<n>layers``), the shape and the mesh
    (``make_local_mesh(1, device="meta")`` for one card: its tag is then
    ``mesh<sizes>``); ``hbm`` (bytes, source) the HBM budget."""
    cut = "" if cfg is None else f"__{cfg.num_layers}layers"
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    production = mesh is None
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device="meta")
    if not shape_applicable(cfg.family, shape):
        res = {"skipped": True,
               "reason": "quadratic-attention arch at 500k decode "
                         "(configs.shapes.SUBQUADRATIC_FAMILIES)",
               "arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    else:
        n_total, n_active = count_active_params(Model(cfg, device="meta"))
        meta = {"skipped": False, "arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "devices": mesh.size,
                "mesh": dict(mesh.shape), "config": cfg.name,
                "num_layers": cfg.num_layers,
                "global_batch": shape.global_batch,
                "seq_len": shape.seq_len,
                "params_total": n_total, "params_active": n_active}
        res = analyze(cfg, shape, mesh, meta, hbm)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = (f"{arch}__{shape_name}__"
               f"{mesh_tag(mesh, multi_pod, production)}{cut}")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    return res


def summary(res: Dict[str, Any], label: str) -> str:
    """The reference's one-line report of a cell."""
    if res.get("skipped"):
        return f"[dryrun] {label}: SKIP ({res['reason']})"
    r, m = res["roofline"], res["memory"]
    return (f"[dryrun] {label}: OK trace={res['compile_seconds']}s "
            f"hbm={m['hbm_used_bytes'] / 2 ** 30:.2f}GiB "
            f"fits={m['fits_hbm']} compute={r['compute_s']:.4f}s "
            f"mem={r['memory_s']:.4f}s coll=n/a dom={r['dominant']} "
            f"roofline_frac={r['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    for a in archs:
        for s in shapes:
            for mp in meshes:
                label = f"{a} {s} pod{2 if mp else 1}"
                try:
                    print(summary(run_cell(a, s, mp, args.out), label),
                          flush=True)
                except Exception as e:  # noqa: BLE001 — a sweep survives
                    print(f"[dryrun] {label}: FAIL {type(e).__name__}: "
                          f"{str(e)[:300]}", flush=True)


if __name__ == "__main__":
    main()
