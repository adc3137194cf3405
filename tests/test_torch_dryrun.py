"""The port's dry run against the JAX package's, on the CPU.

* Every parameter and cache leaf of every config has the reference's
  logical axes, and the same partition spec over the production meshes
  (16, 16) and (2, 16, 16): the reference's ``LogicalRules`` are built
  from a stand-in mesh that carries only axis names and sizes, so no 256
  devices are needed. The serving layout (``serve_param_specs``) and the
  decode cache's (``cache_specs``) too.
* ``train_batch_axes``, ``decode_axes``, ``moe.decode_ep_axes`` and
  ``count_active_params`` equal the reference's for every config and
  every ``SHAPES`` entry.
* ``launch.op_analysis`` counts the product FLOPs that the reference's
  ``analyze_hlo`` counts in the compiled jitted step, exactly, at
  REDUCED, B = 2, S = 64 (train: the loss and its gradients; prefill).
  Two families differ by products that one package writes as a ``dot``
  and the other as a multiply and a sum; those gaps are pinned to their
  reckoned size (see the test's docstring).
* One REDUCED cell through ``run_cell`` with the reference's JSON keys;
  ``main`` prints SKIP and survives a failing cell.
"""
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import moe as JMOE
from repro.models import param as JPM
from repro.models import registry as JREG
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import moe as MOE
from repro_torch.models import param as PM
from repro_torch.models import registry as REG
from repro_torch.models.registry import Model

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = SHAPES["decode_32k"]


def _meshes(name):
    """(the reference's stand-in mesh, the port's EmulatedMesh)."""
    shape, axes = MESHES[name]
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, np.int8))
    return stand_in, MS.EmulatedMesh(axes, shape, torch.device("meta"))


def _reference_specs(descs, rules):
    return {p: tuple(rules.spec_for(d)) for p, d in JPM._leaf_paths(descs)}


def _port_specs(descs, specs):
    flat = dict(PM.leaf_paths(descs))
    out = {}

    def walk(node, spec, prefix):
        if isinstance(node, PM.ParamDesc):
            out[prefix] = spec
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], prefix + (k,))
        elif isinstance(node, (list, tuple)):
            for i, (n, s) in enumerate(zip(node, spec)):
                walk(n, s, prefix + (str(i),))
    walk(descs, specs, ())
    assert set(out) == set(flat)
    return out


def _axes(descs, paths):
    return {p: (tuple(d.shape), tuple(d.axes), d.dtype)
            for p, d in paths(descs)}


@pytest.mark.parametrize("arch", list_archs())
def test_leaf_axes_and_partition_specs_match_reference(arch):
    """Parameters and the decode_32k cache: each leaf's shape, axes and
    dtype are the reference's, and so are its specs over both production
    meshes under the default rules, the serving rules and the cache's
    rules."""
    assert list_archs() == jax_archs()
    cfg, jcfg = get_config(arch), jax_config(arch)
    model = Model(cfg, device="meta")
    jmodel = JREG.Model(jcfg, None)
    B, S = DECODE.global_batch, DECODE.seq_len
    for descs, jdescs in ((model.param_descs(), jmodel.param_descs()),
                          (model.cache_descs(B, S),
                           jmodel.cache_descs(B, S))):
        assert _axes(descs, PM.leaf_paths) == _axes(jdescs,
                                                    JPM._leaf_paths)
    for name in MESHES:
        jmesh, mesh = _meshes(name)
        rules = JPM.default_rules(jmesh)
        assert (_port_specs(model.param_descs(), model.param_specs(mesh))
                == _reference_specs(jmodel.param_descs(), rules)), name
        serve = rules
        if jcfg.moe is not None:
            r = dict(rules.rules)
            r["experts"] = JMOE.decode_ep_axes(jcfg, jmesh, B)
            serve = JPM.LogicalRules(r, rules.mesh_axis_sizes)
        assert (_port_specs(model.param_descs(),
                            ST.serve_param_specs(model, mesh, B))
                == _reference_specs(jmodel.param_descs(), serve)), name
        baxes, saxes = JREG.decode_axes(jmesh, B, S)
        r = dict(rules.rules)
        r["batch"], r["kv_seq"] = baxes, saxes
        cache_rules = JPM.LogicalRules(r, rules.mesh_axis_sizes)
        assert (_port_specs(model.cache_descs(B, S),
                            ST.cache_specs(model, mesh, B, S))
                == _reference_specs(jmodel.cache_descs(B, S),
                                    cache_rules)), name


def _reference_count_active_params(jcfg):
    """The reference's ``count_active_params``. Importing
    ``repro.launch.dryrun`` prepends a 512-device flag to XLA_FLAGS; jax's
    backend is initialised first, so the flag changes nothing here, and
    the variable is restored for any later subprocess."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return JD.count_active_params(JREG.Model(jcfg, None))


@pytest.mark.parametrize("arch", list_archs())
def test_mesh_axes_and_active_params_match_reference(arch):
    """train_batch_axes, decode_axes and (moe) decode_ep_axes over both
    production meshes and every SHAPES entry, and count_active_params."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in MESHES:
        jmesh, mesh = _meshes(name)
        for shape in SHAPES.values():
            B, S = shape.global_batch, shape.seq_len
            assert (REG.train_batch_axes(mesh, B)
                    == JREG.train_batch_axes(jmesh, B)), (name, shape)
            assert (REG.decode_axes(mesh, B, S)
                    == JREG.decode_axes(jmesh, B, S)), (name, shape)
            if cfg.moe is not None:
                assert (MOE.decode_ep_axes(cfg, mesh, B)
                        == JMOE.decode_ep_axes(jcfg, jmesh, B)), (name,
                                                                  shape)
    assert (D.count_active_params(Model(cfg, device="meta"))
            == _reference_count_active_params(jcfg))


# -- FLOPs against the reference's HLO count ---------------------------------

FLOP_B, FLOP_S = 2, 64


def _zamba2_gap(cfg, kind):
    """The reference's SSD scan (``repro/models/ssm.py:ssd_chunked``)
    multiplies the decay into its 3-operand einsums; XLA's transpose of
    those einsums emits three more ``dot`` ops per chunk in the backward:
    the gradient of the group scores (contracting the heads of a group),
    of C through the inter-chunk output (contracting them again) and of
    the per-head decay (contracting the head dim P). The port multiplies
    the decay and the mask outside its matmuls (``ssd_chunked`` in
    ``repro_torch/models/ssm.py``), so autograd computes those three as a
    multiply and a sum, which no product counter counts. Per Mamba2
    layer: 2 x B x S x H x (K + N + P) FLOPs, K the chunk, N the state
    dim; the forward counts the same on both sides."""
    if kind != "train":
        return 0
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    K = min(s.chunk_size, FLOP_S)
    while FLOP_S % K:
        K -= 1
    return (cfg.num_layers * 2 * FLOP_B * FLOP_S * H
            * (K + s.state_dim + s.head_dim))


def _rwkv6_gap(cfg, kind):
    """The reference computes the wkv scan's bonus diagonal as
    ``einsum("bthd,bthd->bth", r * u, k)`` (``repro/models/rwkv.py:
    wkv6_chunked``), a ``dot`` contracting the head dim D; the port as
    ``(r * u * k).sum(-1)``, a multiply and a sum. 2 x B x S x H x D
    FLOPs per layer, in the forward only: XLA's transpose of that dot is
    broadcast multiplies, in both packages the backward counts the same."""
    H = cfg.d_model // cfg.resolved_head_dim
    return cfg.num_layers * 2 * FLOP_B * FLOP_S * H * cfg.resolved_head_dim


GAPS = {"zamba2-2.7b": _zamba2_gap, "rwkv6-3b": _rwkv6_gap}
FLOP_CASES = [(a, k) for a in ("granite-3-2b", "llava-next-mistral-7b",
                               "whisper-tiny", "llama4-scout-17b-a16e",
                               "zamba2-2.7b", "rwkv6-3b")
              for k in ("train", "prefill")] + [("deepseek-v3-671b",
                                                 "train")]


def _reference_flops(arch, kind, mesh):
    jcfg = jax_config(arch, reduced=True)
    model = JREG.get_model(jcfg, mesh)
    batch, _ = JREG.input_specs(jcfg, ShapeConfig("t", kind, FLOP_S,
                                                  FLOP_B), mesh)
    fn = (jax.value_and_grad(model.loss) if kind == "train"
          else model.prefill)
    with mesh:
        hlo = jax.jit(fn).lower(model.abstract_params(),
                                batch).compile().as_text()
    return analyze_hlo(hlo)["flops"]


def _port_flops(arch, kind):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="meta")
    mesh = MS.make_local_mesh(1, device="meta")
    batch, _ = REG.input_specs(cfg, ShapeConfig("t", kind, FLOP_S, FLOP_B),
                               mesh)
    params = model.abstract_params()
    with OpAnalysis((params, batch)) as oa:
        if kind == "train":
            ST.loss_and_grads(model, params, batch)
        else:
            model.prefill(params, batch)
    return oa.result()["flops"]


@pytest.mark.parametrize("arch,kind", FLOP_CASES)
def test_op_flops_equal_reference_hlo_flops(arch, kind, mesh):
    """op_analysis's product FLOPs == analyze_hlo's over the reference's
    compiled step on the (1, 1) mesh, exactly; for zamba2 and rwkv6 the
    reference's count less the port's is the gap its function pins
    (:func:`_zamba2_gap`, :func:`_rwkv6_gap`)."""
    want = _reference_flops(arch, kind, mesh)
    got = _port_flops(arch, kind)
    gap = GAPS.get(arch, lambda c, k: 0)(get_config(arch, reduced=True),
                                         kind)
    assert want - got == gap, (want, got, gap)


# -- run_cell / main ---------------------------------------------------------

# the keys of the reference's analyze() (src/repro/launch/dryrun.py)
REFERENCE_KEYS = {
    "top": {"skipped", "arch", "shape", "multi_pod", "devices",
            "params_total", "params_active", "compile_seconds", "memory",
            "cost", "collectives", "roofline"},
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "hbm_used_bytes", "hbm_budget_bytes",
               "fits_hbm", "cpu_f32_artifact_bytes", "fits_hbm_tpu_adjusted"},
    "cost": {"flops_per_device", "bytes_per_device",
             "xla_cost_analysis_flops", "xla_cost_analysis_bytes"},
    "collectives": {"bytes_per_kind", "counts", "total"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_lower_bound_s", "model_flops_total",
                 "hlo_flops_total", "useful_flops_ratio",
                 "roofline_fraction"},
}


def test_run_cell_writes_the_reference_keys(tmp_path):
    """A REDUCED granite train cell on the one-card mesh, end to end: the
    JSON file, every key of the reference's, no collective term and its
    reason, the counted FLOPs, and the memory terms adding up."""
    cfg = get_config("granite-3-2b", reduced=True)
    res = D.run_cell("granite-3-2b", "train_4k", False, str(tmp_path),
                     cfg=cfg, shape=ShapeConfig("train_4k", "train", FLOP_S,
                                                FLOP_B),
                     mesh=MS.make_local_mesh(1, device="meta"))
    path = tmp_path / "granite-3-2b__train_4k__mesh1x1__2layers.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    assert REFERENCE_KEYS["top"] <= set(res)
    for group in ("memory", "cost", "collectives", "roofline"):
        assert REFERENCE_KEYS[group] <= set(res[group]), group
    r, m = res["roofline"], res["memory"]
    assert r["collective_s"] is None and "emulated" in r["collective_note"]
    assert r["dominant"] in ("compute_s", "memory_s")
    assert res["cost"]["flops_per_device"] == _port_flops("granite-3-2b",
                                                          "train")
    assert m["hbm_used_bytes"] == m["peak_live_bytes"] > m["argument_bytes"]
    assert m["fits_hbm"] and m["alias_bytes"] == m["output_bytes"] - 12


def test_main_skips_quadratic_long_500k_and_survives_a_failing_cell(
        tmp_path, monkeypatch, capsys):
    D.main(["--arch", "granite-3-2b", "--shape", "long_500k", "--out",
            str(tmp_path)])
    assert "granite-3-2b long_500k pod1: SKIP" in capsys.readouterr().out
    assert json.loads((tmp_path / "granite-3-2b__long_500k__pod1.json")
                      .read_text())["skipped"]

    def broken(*a, **k):
        raise RuntimeError("a broken cell")
    monkeypatch.setattr(D, "run_cell", broken)
    D.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--both-meshes",
            "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("FAIL RuntimeError: a broken cell") == 2
