"""Import and device rules of the PyTorch port.

* Importing every ``repro_torch`` module, ``chip_smoke`` and every
  ``examples/torch_*.py`` loads neither JAX nor any module of the
  reference package, nor ``msgpack`` or ``ml_dtypes`` (the card's machine
  has neither).
* ``DFASystem`` (and so ``ServingLoop`` / ``serve_trace``), the LM
  ``Model``, the serving launcher, the two converters and
  ``checkpoint.restore`` run on the card by default: without a card they
  raise unless the caller asks for ``device="cpu"``.
* A kernel wrapper handed a CPU tensor runs the plain version, because
  the tensor lies on the CPU; its launch counter stays 0, and
  ``backend="cuda"`` on a CPU tensor raises instead of falling back.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED, get_config
from repro_torch.core.pipeline import DFASystem
from repro_torch.kernels import dispatch
from repro_torch.kernels.derived_features import kernel as DK
from repro_torch.kernels.derived_features import ops as DF
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flow_moments import kernel as FK
from repro_torch.kernels.flow_moments import ops as FM
from repro_torch.kernels.gather_enrich import kernel as GK
from repro_torch.kernels.gather_enrich import ops as GE
from repro_torch.kernels.ingest_update import kernel as IK
from repro_torch.kernels.ingest_update import ops as IO
from repro_torch.kernels.ring_scatter import kernel as RK
from repro_torch.kernels.ring_scatter import ops as RS
from repro_torch.launch import serve as SERVE
from repro_torch.models.registry import Model

ROOT = os.path.join(os.path.dirname(__file__), "..")
KERNELS = (IK.KERNEL, RK.KERNEL, GK.KERNEL, FK.KERNEL, DK.KERNEL, AK.KERNEL,
           BK.KERNEL)

_PROBE = """
import glob, importlib, importlib.util, os, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
examples = sorted(glob.glob(os.path.join({root!r}, "examples", "torch_*.py")))
for path in examples:
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m.split(".")[0] in ("msgpack", "ml_dtypes"))
print(len(names), len(examples), bad)
"""


def test_port_imports_neither_jax_nor_the_reference():
    src = os.path.abspath(os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=src,
                                             root=os.path.abspath(ROOT))],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    n, n_examples, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 30 and int(n_examples) == 4, out.stdout
    assert bad == "[]", f"port pulled in {bad}"


def test_system_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is legitimate")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DFASystem(REDUCED)
    assert DFASystem(REDUCED, device="cpu").device.type == "cpu"
    cfg = get_config("granite-3-2b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE.main(["--reduced", "--gen", "2"])
    from repro_torch.convert import (lm_params_from_numpy, state_from_numpy,
                                     state_to_numpy)
    from repro_torch.launch import serving as SERVING
    from repro_torch.data import packets as PK
    st = state_to_numpy(DFASystem(REDUCED, device="cpu").init_state())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy(st)
    assert state_from_numpy(st, device="cpu").collector.memory.device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy({}, cfg)
    # the serving loop runs where its system runs
    ev, nows = PK.period_batches(1, 2, REDUCED.event_block, n_flows=8)
    rep = SERVING.serve_trace(DFASystem(REDUCED, device="cpu"), ev, nows,
                              periods=1)
    assert rep.last.enriched.device.type == "cpu"
    assert not SERVING.HostIngestRing("cpu", 8).on_card


def test_training_and_examples_default_to_the_card(tmp_path):
    """``launch.train.main`` and every ``examples/torch_*.py`` entry run
    on the card unless asked for the CPU: without one they raise, naming
    ``device='cpu'``, before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is legitimate")
    import importlib.util
    from repro_torch.launch import train as TRAIN
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRAIN.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    for name in ("torch_quickstart", "torch_serve_traffic_inference",
                 "torch_train_flow_classifier", "torch_train_lm_e2e"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])
    assert not os.listdir(tmp_path)


def test_cpu_tensors_run_the_plain_versions(rng):
    for k in KERNELS:
        k.launches = 0
    F, H = 16, 4
    mem = torch.zeros(F, H, 16, dtype=torch.int32)
    ev = torch.zeros(F, H, dtype=torch.bool)
    pays = torch.from_numpy(rng.integers(0, 1 << 30, (5, 16)).astype(
        np.int32))
    flow = torch.tensor([1, 2, 3, 1, 2])
    hist = torch.tensor([0, 1, 2, 0, 1])
    RS.ring_scatter(mem, ev, pays, flow, hist, torch.ones(5, dtype=bool))
    assert torch.equal(mem[1, 0], pays[3]) and int(ev.sum()) == 3
    cfg = REDUCED
    feats = GE.gather_enrich(mem, ev, flow, cfg)
    assert feats.shape == (5, cfg.derived_dim)
    sl = torch.tensor([0, 0, 1, 16, 16, 16, 16, 16], dtype=torch.int32)
    z = torch.zeros(8, dtype=torch.int32)
    out = IO.segment_sums(sl, z + 5, z + 100, z, z, bits=7, tile=4)
    assert out.shape == (8, 8) and int(out[1, 0]) == 2
    regs = torch.zeros(F, 7, dtype=torch.int32)
    slots = torch.tensor([3, 3, 15, 2, 0])
    deltas = torch.ones(5, 7, dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True])
    acc = FM.flow_moments(regs, slots, deltas, valid)
    assert int(acc[3, 0]) == 2 and int(acc.sum()) == 4 * 7
    derived = DF.derived_features(mem[flow], ev[flow], cfg)
    assert torch.equal(derived, feats)
    q = torch.from_numpy(rng.standard_normal((4, 9, 8)).astype(np.float32))
    kv = q[::2].contiguous()
    att = FA.flash_attention(q, kv, kv, group=2)
    assert att.shape == (4, 9, 8) and bool(torch.isfinite(att).all())
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    with pytest.raises(RuntimeError, match="backend 'cuda'"):
        RS.ring_scatter(mem, ev, pays, flow, hist, torch.ones(5, dtype=bool),
                        backend="cuda")
    with pytest.raises(RuntimeError, match="backend 'cuda'"):
        FM.flow_moments(regs, slots, deltas, valid, backend="cuda")
    with pytest.raises(RuntimeError, match="backend 'cuda'"):
        DF.derived_features(mem[flow], ev[flow], cfg, backend="cuda")
    with pytest.raises(RuntimeError, match="backend 'cuda'"):
        FA.flash_attention(q, kv, kv, group=2, backend="cuda")
    with pytest.raises(ValueError, match="TPU backend"):
        dispatch.check_backend("interpret")


def test_build_is_lazy_and_named_by_source_hash():
    """No library is built or loaded by importing or by CPU use; the
    library name changes with the sources it is built from."""
    from repro_torch.kernels import build
    for k in KERNELS:
        assert k._fn is None
        assert os.path.exists(os.path.join(ROOT, k.source))
    p = build._library_path("ring_scatter", build.BUILD_DIR)
    assert p.name.startswith("ring_scatter-") and p.suffix == ".so"
    assert p != build._library_path("gather_enrich", build.BUILD_DIR)
