"""The port's checkpoints (JSON manifest + npz leaves): round trip, keep-k
GC, async saves, no partial checkpoint visible, interleaved async saves,
NamedTuple class fidelity, bf16, a live ``DFAState`` round trip then one
more step, ``stream`` with snapshots equal to ``stream`` without, and
``ServingLoop`` snapshots equal to the JAX reference's restored
snapshots at the same steps.
"""
import dataclasses
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.compat import make_mesh
from repro.configs import get_dfa_config
from repro.core.pipeline import DFASystem as JSystem
from repro.data import packets as JPK
from repro.launch import serving as JSERVE
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import REDUCED
from repro_torch.core.pipeline import DFAState, DFASystem
from repro_torch.core.collector import CollectorState
from repro_torch.data import packets as PK
from repro_torch.launch import serving as SERVE
from test_torch_overlap import assert_streams_equal
from test_torch_pipeline import assert_state_equal, traces


def flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [] if tree is None else [tree]


def tree_eq(a, b):
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.fixture()
def tree(rng):
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((8, 4)).astype(np.float32)),
                       "stack": [torch.arange(6, dtype=torch.int32),
                                 torch.ones(2, 3, dtype=torch.bfloat16)]},
            "opt": (torch.zeros(()), {"mu": torch.full((4,), 2.0)}),
            "flags": torch.tensor([True, False]),
            "none_leaf": None}


def test_roundtrip(tmp_path, tree):
    C.save(tree, str(tmp_path), step=7)
    got, step = C.restore(str(tmp_path), device="cpu")
    assert step == 7
    tree_eq(tree, got)
    assert got["none_leaf"] is None and isinstance(got["opt"], tuple)
    names = sorted(os.listdir(tmp_path / "step_7"))
    assert names == ["leaves.npz", "manifest.json"]


def test_latest_and_keep_k(tmp_path, tree):
    for s in (1, 2, 3, 4, 5):
        C.save(tree, str(tmp_path), step=s, keep=3)
    assert C.list_steps(str(tmp_path)) == [3, 4, 5]
    assert C.latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path / "empty"), device="cpu")


def test_async_save(tmp_path, tree):
    t = C.save(tree, str(tmp_path), step=1, async_=True)
    assert isinstance(t, threading.Thread)
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = C.restore(str(tmp_path), device="cpu")
    tree_eq(tree, got)


def test_save_copies_before_returning(tmp_path):
    """Mutating a leaf right after an async save does not reach the
    checkpoint (the pipeline writes its ring in place)."""
    x = torch.arange(8, dtype=torch.int32)
    t = C.save({"x": x}, str(tmp_path), step=1, async_=True)
    x += 100
    t.join(timeout=60)
    got, _ = C.restore(str(tmp_path), device="cpu")
    assert torch.equal(got["x"], torch.arange(8, dtype=torch.int32))


def test_no_partial_checkpoint_visible(tmp_path):
    os.makedirs(tmp_path / "step_9.tmp")
    os.makedirs(tmp_path / "step_4")           # no manifest yet
    assert C.list_steps(str(tmp_path)) == []


def test_restore_defaults_to_the_card(tmp_path, tree):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is legitimate")
    C.save(tree, str(tmp_path), step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.restore(str(tmp_path))


class Inner(NamedTuple):
    counts: torch.Tensor
    gone: Optional[torch.Tensor] = None


class Outer(NamedTuple):
    inner: Inner
    tag: torch.Tensor


def test_namedtuple_roundtrip_preserves_class(tmp_path):
    C.register_namedtuple(Inner)
    C.register_namedtuple(Outer)
    t = Outer(Inner(counts=torch.arange(5, dtype=torch.int32)),
              tag=torch.ones(3, dtype=torch.bfloat16))
    C.save(t, str(tmp_path), step=1)
    got, _ = C.restore(str(tmp_path), device="cpu")
    assert type(got) is Outer and type(got.inner) is Inner
    assert got.inner.gone is None
    assert torch.equal(got.inner.counts, t.inner.counts)
    assert got.tag.dtype == torch.bfloat16 and torch.equal(got.tag, t.tag)


def test_unregistered_namedtuple_keeps_attribute_access(tmp_path):
    class Private(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    C.save(Private(torch.zeros(2), torch.ones(3)), str(tmp_path), step=1)
    C._NT_REGISTRY.pop("Private", None)
    got, _ = C.restore(str(tmp_path), device="cpu")
    assert got._fields == ("a", "b")
    assert torch.equal(got.b, torch.ones(3))


def test_bf16_roundtrip_bits(tmp_path):
    x = (torch.arange(-40, 40, dtype=torch.float32) * 1.37e-3).to(
        torch.bfloat16)
    x[0] = float("inf")
    x[1] = float("nan")
    C.save({"x": x}, str(tmp_path), step=1)
    got, _ = C.restore(str(tmp_path), device="cpu")
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    import json
    man = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert man["meta"]["x"]["dtype"] == "bfloat16"


def test_gc_keep_zero_deletes_everything(tmp_path, tree):
    for s in (1, 2):
        C.save(tree, str(tmp_path), step=s)
    with C._IO_LOCK:
        C._gc(str(tmp_path), keep=0)
    assert C.list_steps(str(tmp_path)) == []


def test_interleaved_async_saves_keep_last_k(tmp_path, tree):
    threads = [C.save(tree, str(tmp_path), step=s, keep=3, async_=True)
               for s in range(1, 9)]
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert C.list_steps(str(tmp_path)) == [6, 7, 8]
    for s in (6, 7, 8):
        got, step = C.restore(str(tmp_path), step=s, device="cpu")
        assert step == s
        tree_eq(tree, got)


def test_dfa_state_roundtrip_then_step_bitwise(tmp_path):
    ts = DFASystem(REDUCED, device="cpu")
    _, _, tev, tnows = traces(T=2, n_flows=40)
    ev = [{k: v[t] for k, v in tev.items()} for t in range(2)]
    live = ts.dfa_step(ts.init_state(), ev[0], tnows[0]).state
    C.save(live, str(tmp_path), step=1)
    restored, _ = C.restore(str(tmp_path), device="cpu")
    assert type(restored) is DFAState
    assert type(restored.collector) is CollectorState
    tree_eq(live, restored)
    out_a = ts.dfa_step(live, ev[1], tnows[1])
    out_b = ts.dfa_step(restored, ev[1], tnows[1])
    tree_eq(out_a.state, out_b.state)
    assert torch.equal(out_a.enriched, out_b.enriched)


@pytest.mark.parametrize("overlapped", [False, True])
def test_stream_with_snapshots_equals_stream_without(tmp_path, overlapped):
    cfg = dataclasses.replace(REDUCED, snapshot_every_periods=2)
    ts = DFASystem(cfg, device="cpu")
    _, _, tev, tnows = traces(T=5, n_flows=40)
    plain = DFASystem(REDUCED, device="cpu").stream(
        DFASystem(REDUCED, device="cpu").init_state(), tev, tnows,
        overlapped=overlapped)
    snap = ts.stream(ts.init_state(), tev, tnows, overlapped=overlapped,
                     snapshot_dir=str(tmp_path), snapshot_start=10)
    assert_streams_equal(plain, snap)
    assert C.list_steps(str(tmp_path)) == [12, 14, 15]
    restored, step = C.restore(str(tmp_path), device="cpu")
    assert step == 15
    tree_eq(restored, snap.state)


def test_serving_snapshots_match_jax(tmp_path):
    """Both packages' ServingLoops snapshot every 2 periods of a 5-period
    run (steps 2, 4 and the final 5); each restored snapshot of the port
    equals the reference's restored snapshot of the same step."""
    kw = {"snapshot_every_periods": 2}
    js = JSystem(dataclasses.replace(get_dfa_config(reduced=True),
                                     kernel_backend="ref", **kw),
                 make_mesh((1, 1), ("data", "model")))
    ts = DFASystem(dataclasses.replace(REDUCED, **kw), device="cpu")
    jev, jnows = JPK.period_batches(1, 3, 128, n_flows=40, flow_seed=1)
    tev, tnows = PK.period_batches(1, 3, 128, n_flows=40, flow_seed=1)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = JSERVE.ServingLoop(js, JSERVE.build_source(js, jev, jnows),
                            snapshot_dir=jdir).run(5)
    tr = SERVE.ServingLoop(ts, SERVE.build_source(ts, tev, tnows),
                           snapshot_dir=tdir).run(5)
    assert jr.snapshots == tr.snapshots == 3
    assert C.list_steps(tdir) == JC.list_steps(jdir) == [2, 4, 5]
    for s in (2, 4, 5):
        jstate, _ = JC.restore(jdir, step=s)
        tstate, _ = C.restore(tdir, step=s, device="cpu")
        assert_state_equal(jstate, tstate, f"step {s}: ")
    tree_eq(C.restore(tdir, device="cpu")[0], tr.last.state)
    off = SERVE.serve_trace(DFASystem(REDUCED, device="cpu"), tev, tnows,
                            periods=2)
    assert off.snapshots == 0
