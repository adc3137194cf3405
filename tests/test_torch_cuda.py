"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``gpu``: whether a card is present is decided inside the
``cuda`` fixture, so every worker collects the same tests; on a host
without one they skip. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which the card's host
need not have).

Integers must match bit for bit; features within 1e-5 of each row's
feature scale (``tests/test_gather_enrich_equiv.py``); attention within
2e-5 in f32 and 2e-2 in bf16 (``tests/test_flash_kernel.py``).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import u32 as U
from repro_torch.configs import REDUCED, get_config
from repro_torch.convert import state_to_numpy
from repro_torch.core import reporter as TR
from repro_torch.core.pipeline import DFASystem
from repro_torch.data import packets as PK
from repro_torch.kernels.derived_features import kernel as DK
from repro_torch.kernels.derived_features import ops as DF
from repro_torch.kernels.flash_attention import bwd_kernel as BK
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.flow_moments import kernel as FK
from repro_torch.kernels.flow_moments import ops as FM
from repro_torch.kernels.gather_enrich import kernel as GK
from repro_torch.kernels.gather_enrich import ops as GE
from repro_torch.kernels.ingest_update import kernel as IK
from repro_torch.kernels.ingest_update import ops as IO
from repro_torch.kernels.ring_scatter import kernel as RK
from repro_torch.kernels.ring_scatter import ops as RS
from repro_torch.models.registry import Model
from torch_corners import corner_ids, corner_ring

ROOT = os.path.join(os.path.dirname(__file__), "..")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def row_scaled_err(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().amax(-1, keepdim=True).clamp(min=1.0)
    return float(((got - ref).abs() / scale).max())


@pytest.mark.parametrize("E,tile", [(4096, 256), (1000, 64), (300, 7)])
def test_ingest_segment_sums_bitwise(cuda, E, tile):
    flows = PK.gen_flows(512, seed=1)
    ev = PK.events_to_torch(PK.gen_events(flows, (1 << 32) - 5000, 20_000,
                                          E, seed=2), cuda)
    st = TR.init_state(dataclasses.replace(REDUCED, flows_per_shard=512),
                       cuda)
    slots = TR.hash_slot(ev["five_tuple"], 512)
    s = IK.stream_prep(st.last_ts, st.keys, st.active, slots, ev["ts"],
                       ev["size"], ev["five_tuple"], ev["valid"], tile)
    args = (s.s_slot, s.s_ts, s.s_ps, s.base_ts, s.first.to(torch.int32))
    before = IK.KERNEL.launches
    got = IO.segment_sums(*args, bits=7, tile=s.tile)
    assert IK.KERNEL.launches == before + 1
    want = IO.segment_sums(*args, bits=7, tile=s.tile, backend="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_cells", [0, 5])
def test_ring_scatter_bitwise_with_duplicate_cells(cuda, n_cells):
    g = torch.Generator().manual_seed(n_cells)
    F, H, R = 1024, 10, 512
    mem = torch.randint(-(1 << 31), (1 << 31) - 1, (F, H, 16), generator=g,
                        dtype=torch.int32).to(cuda)
    ev = (torch.rand(F, H, generator=g) < 0.3).to(cuda)
    pays = torch.randint(-(1 << 31), (1 << 31) - 1, (R, 16), generator=g,
                         dtype=torch.int32).to(cuda)
    if n_cells:
        cell = torch.randint(0, n_cells, (R,), generator=g)
        flow, hist = (cell * 37) % F, cell % H
    else:
        flow = torch.randint(0, F, (R,), generator=g)
        hist = torch.randint(0, H, (R,), generator=g)
    flow, hist = flow.to(cuda), hist.to(cuda)
    mask = (torch.rand(R, generator=g) < 0.8).to(cuda)
    mk, vk = mem.clone(), ev.clone()
    RS.ring_scatter(mk, vk, pays, flow, hist, mask)
    RS.ring_scatter(mem, ev, pays, flow, hist, mask, backend="ref")
    assert torch.equal(mk, mem) and torch.equal(vk, ev)


@pytest.mark.parametrize("R,H", [(4096, 10), (100, 8), (1, 1)])
def test_gather_enrich_row_scaled(cuda, R, H):
    g = torch.Generator().manual_seed(R)
    F = 4096
    mem, valid = PK.synthetic_ring(F, H, g)
    lf = torch.randint(-3, F + 3, (R,), generator=g)
    cfg = dataclasses.replace(REDUCED, flows_per_shard=F, history=H)
    got = GE.gather_enrich(mem.to(cuda), valid.to(cuda), lf.to(cuda), cfg)
    want = GE.gather_enrich(mem, valid, lf, cfg)        # plain, on the CPU
    ref_card = GE.gather_enrich(mem.to(cuda), valid.to(cuda), lf.to(cuda),
                                cfg, backend="ref")
    assert bool(torch.isfinite(got).all())
    assert row_scaled_err(got, want) <= 1e-5
    assert row_scaled_err(got, ref_card) <= 1e-5


@pytest.mark.parametrize("flow_home,exchange", [
    ("ingest", "padded"), ("hash", "padded"), ("hash", "ragged"),
    ("rendezvous", "padded")])
def test_mesh_kernels_equal_plain_on_card(cuda, flow_home, exchange):
    """The emulated 4-shard mesh (1-D under "ingest", (2, 2) otherwise):
    K1 per port, K2 and K3 per shard on views of the stacked rings; the
    kernel run equals the plain run."""
    from repro_torch.configs import REDUCED_MULTIPOD
    from repro_torch.data import scenarios as SC
    if flow_home == "ingest":
        cfg = REDUCED
        events, nows = PK.period_batches(4, 3, 256, n_flows=300,
                                         flow_seed=2, device=cuda)
    else:
        cfg = dataclasses.replace(REDUCED_MULTIPOD, flow_home=flow_home,
                                  crosspod_exchange=exchange)
        ev, now = SC.build("cross_pod_mix", 4, 64, 3, seed=1)
        events = {k: (torch.from_numpy(v).to(cuda) if k == "valid"
                      else U.from_numpy(v, cuda)) for k, v in ev.items()}
        nows = torch.from_numpy(now.astype(np.int64)).to(cuda)
    system = DFASystem(cfg, device=cuda, n_shards=4)
    kernels = (IK.KERNEL, RK.KERNEL, GK.KERNEL)
    before = [k.launches for k in kernels]
    a = system.run_periods(system.init_state(), events, nows)
    assert all(k.launches >= n + 3 * 4 for k, n in zip(kernels, before))
    b = system.run_periods(system.init_state(), events, nows, backend="ref")
    for x, y in zip(state_to_numpy(a.state), state_to_numpy(b.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k]), k
    assert torch.equal(a.flow_ids, b.flow_ids)
    fin = torch.isfinite(b.enriched)
    assert torch.equal(fin, torch.isfinite(a.enriched))
    assert row_scaled_err(torch.where(fin, a.enriched, 0.0).reshape(-1, 96),
                          torch.where(fin, b.enriched, 0.0).reshape(-1, 96)
                          ) <= 1e-5


def test_pipeline_kernels_equal_plain_on_card(cuda):
    system = DFASystem(dataclasses.replace(REDUCED, inference_head="mlp"),
                       device=cuda)
    events, nows = PK.period_batches(1, 4, 512, n_flows=200, flow_seed=1,
                                     device=cuda)
    launches = [k.launches for k in (IK.KERNEL, RK.KERNEL, GK.KERNEL)]
    a = system.run_periods(system.init_state(), events, nows)
    assert all(k.launches >= n + 4 for k, n in
               zip((IK.KERNEL, RK.KERNEL, GK.KERNEL), launches))
    b = system.run_periods(system.init_state(), events, nows, backend="ref")
    for x, y in zip(state_to_numpy(a.state), state_to_numpy(b.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k])
    assert row_scaled_err(a.enriched.reshape(-1, 96),
                          b.enriched.reshape(-1, 96)) <= 1e-5


@pytest.mark.parametrize("E,one_slot", [(4096, False), (1000, False),
                                        (300, False), (4096, True)])
def test_flow_moments_bitwise(cuda, E, one_slot):
    """K4 == its plain version bit for bit, heavy contention included
    (every event on one slot); registers wrap mod 2^32."""
    g = torch.Generator().manual_seed(E + one_slot)
    F = 512
    regs = torch.randint(-(1 << 31), (1 << 31) - 1, (F, 7), generator=g,
                         dtype=torch.int32)
    slots = (torch.zeros(E, dtype=torch.int64) if one_slot
             else torch.randint(0, F, (E,), generator=g))
    deltas = torch.randint(-(1 << 31), (1 << 31) - 1, (E, 7), generator=g,
                           dtype=torch.int32)
    valid = torch.rand(E, generator=g) < 0.85
    before = FK.KERNEL.launches
    got = FM.flow_moments(*(t.to(cuda) for t in (regs, slots, deltas,
                                                 valid)))
    assert FK.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), FM.flow_moments(regs, slots, deltas, valid))


def moments_case(case, g):
    """(regs, slots, deltas, valid) on the CPU for one K4 corner."""
    F, E = {"even and odd slots, F odd": (511, 5000), "one slot": (64, 4096),
            "wrapping registers": (33, 20000), "one delta per row": (101, 3000),
            "all deltas zero": (101, 3000), "E=0": (17, 0),
            "E=1": (17, 1)}[case]
    regs = torch.randint(-(1 << 31), (1 << 31) - 1, (F, 7), generator=g,
                         dtype=torch.int32)
    slots = torch.randint(0, F + 3, (E,), generator=g)   # some past F
    deltas = torch.randint(-(1 << 31), (1 << 31) - 1, (E, 7), generator=g,
                           dtype=torch.int32)
    deltas[torch.rand(E, 7, generator=g) < 0.2] = 0
    valid = torch.rand(E, generator=g) < 0.9
    if case == "one slot":
        slots[:] = 7
    if case == "wrapping registers":    # every register wraps often
        regs[:] = -16                   # 0xFFFFFFF0
        deltas[:, :] = torch.randint(0x10, 1 << 30, (E, 7), generator=g,
                                     dtype=torch.int32)
    if case == "one delta per row":     # register 0 (odd), 6 (even) only
        odd = (slots & 1).bool()
        keep = torch.zeros(E, 7, dtype=torch.bool)
        keep[:, 0], keep[:, 6] = odd, ~odd
        deltas = torch.where(keep, deltas, torch.zeros_like(deltas))
    if case == "all deltas zero":
        deltas.zero_()
    return regs, slots, deltas, valid


@pytest.mark.parametrize("case", ["even and odd slots, F odd", "one slot",
                                  "wrapping registers", "one delta per row",
                                  "all deltas zero", "E=0", "E=1"])
def test_flow_moments_corners(cuda, case):
    """K4 on rows of both parities (28-byte rows straddle 32-byte
    sectors), one hot slot, registers that wrap many times, sparse and
    all-zero deltas, E = 0 and 1 (E not a multiple of a warp's 4 events):
    bit for bit against the plain version, one launch per non-empty
    call."""
    g = torch.Generator().manual_seed(len(case))
    regs, slots, deltas, valid = moments_case(case, g)
    before = FK.KERNEL.launches
    got = FM.flow_moments(*(t.to(cuda) for t in (regs, slots, deltas,
                                                 valid)))
    torch.cuda.synchronize()
    assert FK.KERNEL.launches == before + int(slots.shape[0] > 0)
    want = FM.flow_moments(regs, slots, deltas, valid)
    assert torch.equal(got.cpu(), want)
    if case == "all deltas zero":
        assert torch.equal(got.cpu(), regs)


def scatter_case(case, g):
    """(F, H, flow, hist, mask) on the CPU for one K2 corner."""
    F, H, C = 1024, 10, RK.round_rows()
    R = {"multi-round duplicates": 4 * C + 17, "one cell": 3000,
         "outside the ring": 3000, "R=0": 0, "R=1": 1,
         "distinct R=4096": 4096}[case]
    flow = torch.randint(0, F, (R,), generator=g)
    hist = torch.randint(0, H, (R,), generator=g)
    if case == "multi-round duplicates":      # 40 cells, in every round
        cell = torch.randint(0, 40, (R,), generator=g)
        flow, hist = (cell * 37) % F, cell % H
    if case == "one cell":
        flow[:], hist[:] = 5, 3
    if case == "outside the ring":
        flow = torch.randint(-3, F + 3, (R,), generator=g)
        hist = torch.randint(-2, H + 2, (R,), generator=g)
    if case == "distinct R=4096":
        cells = torch.randperm(F * H, generator=g)[:R]
        flow, hist = cells // H, cells % H
    mask = torch.rand(R, generator=g) < 0.9
    return F, H, flow, hist, mask


@pytest.mark.parametrize("case", ["multi-round duplicates", "one cell",
                                  "outside the ring", "R=0", "R=1",
                                  "distinct R=4096"])
def test_ring_scatter_one_launch_corners(cuda, case):
    """K2's partitions and rounds: duplicates whose last write lies in a
    later round, one cell for every row, rows outside the ring, R = 0, 1
    and 4096 distinct cells: bit for bit against the plain version, one
    launch per non-empty call."""
    g = torch.Generator().manual_seed(len(case))
    F, H, flow, hist, mask = scatter_case(case, g)
    R = flow.shape[0]
    mem = torch.randint(-(1 << 31), (1 << 31) - 1, (F, H, 16), generator=g,
                        dtype=torch.int32)
    ev = torch.rand(F, H, generator=g) < 0.3
    pays = torch.randint(-(1 << 31), (1 << 31) - 1, (R, 16), generator=g,
                         dtype=torch.int32)
    if case == "multi-round duplicates":      # a winner past round 0 that
        cells = flow * H + hist                # also had a writer in it
        C = RK.round_rows()
        first = cells[:C][mask[:C]]
        last = cells[C * 4:][mask[C * 4:]]
        assert bool(torch.isin(last, first).any())
    mk, vk = mem.to(cuda), ev.to(cuda)
    before = RK.KERNEL.launches
    RS.ring_scatter(mk, vk, pays.to(cuda), flow.to(cuda), hist.to(cuda),
                    mask.to(cuda))
    torch.cuda.synchronize()
    assert RK.KERNEL.launches == before + int(R > 0)
    RS.ring_scatter(mem, ev, pays, flow, hist, mask)    # plain, on the CPU
    assert torch.equal(mk.cpu(), mem) and torch.equal(vk.cpu(), ev)


@pytest.mark.parametrize("N,H", [(4096, 10), (100, 8), (1, 1)])
@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_derived_features_row_scaled(cuda, N, H, wire):
    g = torch.Generator().manual_seed(N * H)
    mem, valid = PK.synthetic_ring(N, H, g)
    if wire == "v2":                       # hist_idx lives in word 15
        mem[..., 15] = mem[..., 13]
    cfg = dataclasses.replace(REDUCED, history=H, wire_format=wire)
    before = DK.KERNEL.launches
    got = DF.derived_features(mem.to(cuda), valid.to(cuda), cfg)
    assert DK.KERNEL.launches == before + 1
    assert got.shape == (N, cfg.derived_dim)
    assert bool(torch.isfinite(got).all())
    assert row_scaled_err(got, DF.derived_features(mem, valid, cfg)) <= 1e-5


def _corners(H, D, rows, wire, seed):
    """A corner ring (``tests/torch_corners.py``) as port tensors, and
    the config that reads it."""
    mem, valid = corner_ring(np.random.default_rng(seed), rows, H, wire)
    cfg = dataclasses.replace(REDUCED, history=H, derived_dim=D,
                              wire_format=wire)
    return U.from_numpy(mem), torch.from_numpy(valid), cfg


@pytest.mark.parametrize("N", [1, 4095, 4096])
@pytest.mark.parametrize("D", [40, 96, 128])
@pytest.mark.parametrize("H", [1, 10, 16, 17, 33])
def test_derived_features_corners(cuda, H, D, N):
    """K5 at the selection corners (ties, all-zero counts with entry 0
    invalid, counts >= 2^31, all-invalid rows), H from one entry to more
    entries than a warp has lanes, truncated / PAPER / padded D, under
    both wire formats."""
    for wire in ("v1", "v2"):
        mem, valid, cfg = _corners(H, D, N, wire, H * 7919 + D * 31 + N)
        before = DK.KERNEL.launches
        got = DF.derived_features(mem.to(cuda), valid.to(cuda), cfg)
        assert DK.KERNEL.launches == before + 1
        assert got.shape == (N, D) and bool(torch.isfinite(got).all())
        assert row_scaled_err(got, DF.derived_features(mem, valid, cfg)) \
            <= 1e-5


@pytest.mark.parametrize("R", [1, 4095, 4096])
@pytest.mark.parametrize("D", [40, 96, 128])
@pytest.mark.parametrize("H", [1, 10, 16, 17, 33])
def test_gather_enrich_corners(cuda, H, D, R):
    """K3 at the same corners, with ids below 0 and at or above F
    (clamped) and duplicate ids."""
    F = 4096
    for wire in ("v1", "v2"):
        mem, valid, cfg = _corners(H, D, F, wire, H * 7919 + D * 31 + R)
        cfg = dataclasses.replace(cfg, flows_per_shard=F)
        lf = torch.from_numpy(corner_ids(np.random.default_rng(R), R, F))
        before = GK.KERNEL.launches
        got = GE.gather_enrich(mem.to(cuda), valid.to(cuda), lf.to(cuda),
                               cfg)
        assert GK.KERNEL.launches == before + 1
        assert got.shape == (R, D) and bool(torch.isfinite(got).all())
        assert row_scaled_err(got, GE.gather_enrich(mem, valid, lf, cfg)) \
            <= 1e-5


@pytest.mark.parametrize("H", [147, 300, 800])
def test_derive_kernels_long_history(cuda, H):
    """Histories whose shared copy needs the >48 KB opt-in (H > 146) and
    fewer warps per block (H > 691), both kernels."""
    mem, valid, cfg = _corners(H, 96, 64, "v2", H)
    before = (GK.KERNEL.launches, DK.KERNEL.launches)
    lf = torch.from_numpy(corner_ids(np.random.default_rng(H), 70, 64))
    got_g = GE.gather_enrich(mem.to(cuda), valid.to(cuda), lf.to(cuda),
                             dataclasses.replace(cfg, flows_per_shard=64))
    got_d = DF.derived_features(mem.to(cuda), valid.to(cuda), cfg)
    assert (GK.KERNEL.launches, DK.KERNEL.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert row_scaled_err(got_g, GE.gather_enrich(mem, valid, lf, cfg)) \
        <= 1e-5
    assert row_scaled_err(got_d, DF.derived_features(mem, valid, cfg)) \
        <= 1e-5


def test_derive_kernels_take_zero_rows(cuda):
    """R = 0 and N = 0 give an empty (0, D)."""
    mem, valid, cfg = _corners(10, 96, 64, "v1", 0)
    before = (GK.KERNEL.launches, DK.KERNEL.launches)
    got = GE.gather_enrich(mem.to(cuda), valid.to(cuda),
                           torch.zeros(0, dtype=torch.int64, device=cuda),
                           cfg)
    empty = DF.derived_features(mem[:0].to(cuda), valid[:0].to(cuda), cfg)
    torch.cuda.synchronize()
    assert (GK.KERNEL.launches, DK.KERNEL.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert got.shape == (0, 96) and empty.shape == (0, 96)


def test_unfused_step_on_card_equals_fused(cuda):
    """chip_smoke.unfused_step on the card launches K4, K5 and K2 every
    period and matches the fused path: state bitwise, features
    row-scaled."""
    sys.path.insert(0, os.path.abspath(ROOT))
    from chip_smoke import unfused_step
    system = DFASystem(dataclasses.replace(REDUCED, inference_head="mlp"),
                       device=cuda)
    events, nows = PK.period_batches(1, 4, 512, n_flows=200, flow_seed=1,
                                     device=cuda)
    kernels = (FK.KERNEL, DK.KERNEL, RK.KERNEL)
    su, sf = system.init_state(), system.init_state()
    for t in range(4):
        ev = {k: v[t] for k, v in events.items()}
        before = [k.launches for k in kernels]
        u = unfused_step(system, su, ev, nows[t])
        assert all(k.launches > n for k, n in zip(kernels, before))
        f = system.dfa_step(sf, ev, nows[t])
        su, sf = u.state, f.state
        for x, y in zip(state_to_numpy(su), state_to_numpy(sf)):
            for name in type(x)._fields:
                np.testing.assert_array_equal(getattr(x, name),
                                              getattr(y, name))
        for k in f.metrics:
            assert int(u.metrics[k]) == int(f.metrics[k])
        assert row_scaled_err(u.enriched, f.enriched) <= 1e-5
        assert torch.allclose(u.preds, f.preds, rtol=1e-5, atol=1e-5)


ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attention_case(cuda, BH, Sq, Sk, D, Dv, group, dtype, causal, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(BH, Sq, D, generator=g).to(cuda, dtype)
    k = torch.randn(BH // group, Sk, D, generator=g).to(cuda, dtype)
    v = torch.randn(BH // group, Sk, Dv, generator=g).to(cuda, dtype)
    before = AK.KERNEL.launches
    kinds = dict(AK.KERNEL.launches_by_kind)
    got = FA.flash_attention(q, k, v, group=group, causal=causal)
    assert AK.KERNEL.launches == before + 1
    kind = AK.mask_kind(causal)
    assert AK.KERNEL.launches_by_kind == {**kinds, kind: kinds[kind] + 1}
    want = FA.flash_attention(q, k, v, group=group, causal=causal,
                              backend="ref")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (BH, Sq, Dv)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D,group", [(128, 512, 64, 4), (8, 1000, 64, 2),
                                          (4, 64, 16, 1)])
def test_flash_attention_matches_plain(cuda, dtype, BH, S, D, group):
    _attention_case(cuda, BH, S, S, D, D, group, dtype, True, S + D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,D,Dv,causal", [(48, 96, 8, 12, True),
                                               (200, 130, 64, 128, True),
                                               (100, 300, 128, 32, False),
                                               (64, 64, 64, 64, False)])
def test_flash_attention_ragged_and_noncausal(cuda, dtype, Sq, Sk, D, Dv,
                                              causal):
    """Sq != Sk, Dv != D, head dims up to 128, and the full (non-causal)
    softmax."""
    _attention_case(cuda, 6, Sq, Sk, D, Dv, 3, dtype, causal, Sq * Sk)


@pytest.mark.parametrize("BH,Sq,Sk,D,group,causal", [
    (128, 1024, 1024, 64, 4, True),     # the serving shape
    (160, 1024, 1024, 128, 5, True),    # qwen3-14b's serving shape
    (8, 1000, 1000, 64, 4, True),
    (8, 1000, 1000, 128, 4, True),
    (8, 1000, 1000, 64, 1, False),
    (24, 1500, 1500, 64, 1, False),     # whisper-tiny's encoder prefill
    # llava's 2880 patches + 1024 tokens: 30.5 tiles of 128, ragged
    (32, 3904, 3904, 128, 4, True),
    (24, 200, 330, 128, 3, True),       # Sq < Sk, ragged
    (24, 330, 200, 64, 3, True),        # Sq > Sk, ragged
    (16, 200, 330, 64, 8, False),
    (64, 700, 500, 128, 8, True),
    (8, 1, 77, 64, 1, True),
    # D = 192 is MLA's (D, Dv) = (192, 128)
    (512, 1024, 1024, 192, 1, True),    # deepseek-v3's MLA prefill
    (512, 1024, 1024, 192, 1, False),
    (8, 200, 330, 192, 2, True),        # Sq < Sk, ragged
    (8, 200, 330, 192, 2, False),
    (12, 330, 200, 192, 4, True),       # Sq > Sk, ragged
    (12, 330, 200, 192, 4, False),
    (6, 1, 77, 192, 3, True),
])
def test_flash_attention_wgmma_matches_plain(cuda, BH, Sq, Sk, D, group,
                                             causal):
    """K6's tensor-core variants (bf16, (D, Dv) in {(64, 64), (128, 128)}
    on "pingpong", (192, 128) on "wgmma"; (80, 80) in
    test_flash_attention_head_dim_80_both_variants) against the plain
    version at 2e-2 (MLA's with its scale 192 ** -0.5, the default); the
    launch is counted under the variant the rule names and no other
    variant runs."""
    Dv = 128 if D == 192 else D
    g = torch.Generator().manual_seed(BH * Sq + Sk + D)
    q = torch.randn(BH, Sq, D, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(BH // group, Sk, D, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(BH // group, Sk, Dv, generator=g).to(cuda,
                                                         torch.bfloat16)
    want_v = "wgmma" if D == 192 else "pingpong"
    assert AK.variant(q.dtype, D, Dv) == want_v
    before = dict(AK.KERNEL.launches_by_variant)
    got = FA.flash_attention(q, k, v, group=group, causal=causal)
    assert AK.KERNEL.launches_by_variant == {**before,
                                             want_v: before[want_v] + 1}
    want = FA.flash_attention(q, k, v, group=group, causal=causal,
                              backend="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (BH, Sq, Dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_simt_variant_forced(cuda):
    """The SIMT kernel, forced onto the serving shape's bf16 inputs,
    agrees with the ping-pong kernel (the rule's) and the plain version at
    2e-2."""
    g = torch.Generator().manual_seed(11)
    q = torch.randn(16, 300, 64, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(4, 300, 64, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(4, 300, 64, generator=g).to(cuda, torch.bfloat16)
    before = dict(AK.KERNEL.launches_by_variant)
    simt = AK.flash_attention_cuda(q, k, v, group=4, force_variant="simt")
    pingpong = AK.flash_attention_cuda(q, k, v, group=4)
    assert AK.KERNEL.launches_by_variant == {
        **before, "simt": before["simt"] + 1,
        "pingpong": before["pingpong"] + 1}
    want = FA.flash_attention(q, k, v, group=4, backend="ref")
    for got in (simt, pingpong):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Dv,Sq,Sk,group", [
    (192, 128, 1024, 1024, 1),          # deepseek-v3's MLA prefill
    (192, 128, 200, 330, 1),            # ragged, Sq < Sk
    (80, 80, 330, 200, 2),              # zamba2's head dim, Sq > Sk
    (160, 64, 130, 70, 3),
    (256, 256, 100, 257, 1),            # the widest the kernel takes
])
def test_flash_attention_wide_head_dims(cuda, dtype, causal, D, Dv, Sq, Sk,
                                        group):
    """Head dims past 64 (D != Dv) against the plain version: bf16 at
    MLA's (192, 128) and zamba2's (80, 80) on the wgmma kernel, every
    other case on the SIMT kernel."""
    want = ("wgmma" if dtype == torch.bfloat16
            and (D, Dv) in AK.WGMMA_HEAD_DIMS else "simt")
    assert AK.variant(dtype, D, Dv) == want
    before = dict(AK.KERNEL.launches_by_variant)
    _attention_case(cuda, 2 * group, Sq, Sk, D, Dv, group, dtype, causal,
                    D + Dv + Sq)
    assert AK.KERNEL.launches_by_variant == {**before,
                                             want: before[want] + 1}


@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,Sq,Sk,group", [
    (128, 1024, 1024, 1),               # zamba2's prefill shape
    (8, 333, 333, 1), (12, 257, 129, 4), (8, 330, 200, 2)])
def test_flash_attention_head_dim_80_both_variants(cuda, variant, causal,
                                                   BH, Sq, Sk, group):
    """zamba2's head dim 80 in bf16 on K6's wgmma kernel (its own
    variant) and forced onto the SIMT one, each against the plain version
    at 2e-2, counted under the variant that ran; ragged Sq and Sk both
    ways, groups 1, 2 and 4. The wgmma kernel repeats bit for bit and
    agrees with the SIMT kernel at 2e-2."""
    assert AK.variant(torch.bfloat16, 80, 80) == "wgmma"
    q, k, v = _qkv(cuda, BH, Sq, Sk, 80, 80, group, torch.bfloat16,
                   BH + Sq + Sk + causal)
    forced = None if variant == "wgmma" else variant
    before = dict(AK.KERNEL.launches_by_variant)
    got = AK.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                  force_variant=forced)
    assert AK.KERNEL.launches_by_variant == {
        **before, variant: before[variant] + 1}
    want = FR.flash_attention_ref(q, k, v, group=group, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (BH, Sq, 80)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    if variant == "wgmma":
        again = AK.flash_attention_cuda(q, k, v, group=group, causal=causal)
        simt = AK.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                       force_variant="simt")
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), simt.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("BH,S,group,causal", [
    (24, 1500, 1, False),               # whisper's encoder: items cut
    (16, 3904, 4, True),                # llava's 3904 rows, 16 heads
    (4, 3904, 4, True),                 # the same at 4 heads: cut
    (128, 1024, 4, True),               # granite's: whole items
    (8, 1000, 4, True),                 # items cut in up to 4 parts
    (24, 1000, 3, False)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_pingpong_matches_the_other_variants(cuda, BH, S,
                                                             group, causal,
                                                             D):
    """K6's ping-pong kernel (the rule's at bf16 (64, 64) and (128, 128))
    against the plain version, the forced one-schedule wgmma kernel and
    the SIMT kernel at 2e-2, its lse within 1e-4 of the plain logsumexp;
    output and lse repeat bit for bit over two runs; each launch counted
    under the variant that ran. The shapes cover the plan's whole items
    and items cut along the key axis (2 or 3 parts), causal and full,
    ragged last tiles."""
    assert AK.variant(torch.bfloat16, D, D) == "pingpong"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = AK.plan(BH, S, S, causal, sms)
    q, k, v = _qkv(cuda, BH, S, S, D, D, group, torch.bfloat16,
                   BH + S + D + causal)
    before = dict(AK.KERNEL.launches_by_variant)
    got, lse = AK.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                       with_lse=True)
    again, lse2 = AK.flash_attention_cuda(q, k, v, group=group,
                                          causal=causal, with_lse=True)
    others = {n: AK.flash_attention_cuda(q, k, v, group=group, causal=causal,
                                         force_variant=n)
              for n in ("wgmma", "simt")}
    assert AK.KERNEL.launches_by_variant == {
        **before, "pingpong": before["pingpong"] + 2,
        "wgmma": before["wgmma"] + 1, "simt": before["simt"] + 1}
    want_o, want = FR.flash_attention_lse_ref(q, k, v, group=group,
                                              causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    for other in (want_o, *others.values()):
        torch.testing.assert_close(got.float(), other.float(), rtol=2e-2,
                                   atol=2e-2)
    cut = (BH, S) in ((24, 1500), (4, 3904), (8, 1000), (24, 1000))
    assert (plan.n_counters > 0) == cut


@pytest.mark.parametrize("D,Dv", [(257, 64), (64, 257), (320, 320)])
def test_flash_attention_refuses_past_256_on_the_card(cuda, D, Dv):
    """Refused before anything is built or launched, on CUDA tensors too."""
    q = torch.zeros(2, 8, D, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(2, 8, Dv, device=cuda, dtype=torch.bfloat16)
    launches = AK.KERNEL.launches
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(q, q, v)
    assert AK.KERNEL.launches == launches


def test_reduced_deepseek_kernel_equals_plain(cuda):
    """deepseek-v3 at REDUCED (MLA, 1 dense + 3 MoE layers) in f32 on the
    card: the prefill (K6 once per layer, D = 24, Dv = 16), its latent
    cache, and 3 greedy decode steps equal the plain run's to 1e-4 of the
    largest logit."""
    from repro_torch.launch.serve import build_cache
    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    model = Model(cfg, device=cuda)
    plain = Model(cfg, device=cuda, backend="ref")
    params = model.init(0)
    g = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 70), generator=g).to(cuda)
    before = AK.KERNEL.launches
    outs = []
    for m in (model, plain):
        logits, pc = m.prefill(params, {"tokens": tokens})
        cache = build_cache(m, pc, 2, 80)
        seen = [logits]
        tok, pos = logits.argmax(-1)[:, None], torch.full((2,), 70,
                                                          device=cuda)
        for _ in range(3):
            logits, cache = m.decode(params, tok, pos, cache)
            seen.append(logits)
            tok, pos = logits.argmax(-1)[:, None], pos + 1
        outs.append((seen, pc))
    assert AK.KERNEL.launches == before + cfg.num_layers
    (got, gc), (want, wc) = outs
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
    for a, b in zip(gc, wc):
        assert set(a) == {"ckv", "kr"}
        for n in a:
            assert float((a[n] - b[n]).abs().max()) <= 1e-4 * float(
                b[n].abs().max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_reduced_prefill_kernel_equals_plain(cuda, dtype, tol):
    """The REDUCED granite model's prefill through K6 (one launch per
    layer) against the same model on the plain version, on the card;
    tolerances relative to the largest logit."""
    cfg = get_config("granite-3-2b", reduced=True).replace(dtype=dtype,
                                                          param_dtype=dtype)
    model = Model(cfg, device=cuda)
    params = model.init(0)
    plain = Model(cfg, device=cuda, backend="ref")
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 100),
                                     generator=g).to(cuda)}
    before = AK.KERNEL.launches
    got, cache = model.prefill(params, batch)
    assert AK.KERNEL.launches == before + cfg.num_layers
    want, cache_ref = plain.prefill(params, batch)
    assert AK.KERNEL.launches == before + cfg.num_layers
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
    for layer, (a, b) in enumerate(zip(cache, cache_ref)):
        for n in ("k", "v"):
            if layer == 0:                      # computed before attention
                assert torch.equal(a[n], b[n])
            err = float((a[n].float() - b[n].float()).abs().max())
            assert err <= tol * float(b[n].float().abs().max())


# -- the training slice on the card: K6's lse, K7 ------------------------------

def _qkv(cuda, BH, Sq, Sk, D, Dv, group, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(BH, Sq, D, generator=g).to(cuda, dtype),
            torch.randn(BH // group, Sk, D, generator=g).to(cuda, dtype),
            torch.randn(BH // group, Sk, Dv, generator=g).to(cuda, dtype))


@pytest.mark.parametrize("variant,D", [("simt", 64), ("simt", 16),
                                       ("wgmma", 64), ("wgmma", 80),
                                       ("wgmma", 128), ("wgmma", 192),
                                       ("pingpong", 64), ("pingpong", 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_matches_plain(cuda, variant, D, causal):
    """K6's logsumexp output (every variant) against the plain
    logsumexp; f32 for the simt cases, bf16 for the tensor-core ones (D =
    192 with MLA's Dv = 128, D = 80 zamba2's); 1e-4 absolute (lse is
    O(10): a few f32 ulps plus the tensor-core kernels' ex2.approx)."""
    dtype = torch.float32 if variant == "simt" else torch.bfloat16
    Dv = 128 if D == 192 else D
    q, k, v = _qkv(cuda, 16, 333, 333, D, Dv, 4, dtype, D + causal)
    out, lse = AK.flash_attention_cuda(q, k, v, group=4, causal=causal,
                                       force_variant=variant, with_lse=True)
    want_o, want = FR.flash_attention_lse_ref(q, k, v, group=4,
                                              causal=causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (16, 333)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), want_o.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_output_unchanged_by_lse(cuda, dtype):
    """At the serving shape K6's output is bit for bit the same with and
    without the lse output."""
    q, k, v = _qkv(cuda, 128, 1024, 1024, 64, 64, 4, dtype, 3)
    plain = AK.flash_attention_cuda(q, k, v, group=4)
    with_lse, _ = AK.flash_attention_cuda(q, k, v, group=4, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_lse)


def _bwd_inputs(cuda, BH, Sq, Sk, D, Dv, group, dtype, causal, seed):
    q, k, v = _qkv(cuda, BH, Sq, Sk, D, Dv, group, dtype, seed)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(BH, Sq, Dv, generator=g).to(cuda, dtype)
    o, lse = FR.flash_attention_lse_ref(q, k, v, group=group, causal=causal)
    return q, k, v, o, lse, do


def _grad_err(got, want):
    """max |got - want| over max |want|, the worst of dq, dk, dv."""
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


_BWD_SHAPES = [
    (8, 333, 333, 64, 64, 1), (16, 333, 333, 64, 64, 4),
    (8, 200, 71, 16, 16, 4), (8, 71, 200, 128, 128, 4),
    (12, 129, 257, 128, 32, 4), (4, 3, 65, 64, 64, 1),
    (8, 200, 71, 64, 64, 4), (8, 333, 333, 128, 128, 1),
    (16, 333, 333, 128, 128, 4),
    # past head dim 128: MLA's (192, 128) (wgmma in bf16; ragged with
    # group 4 too), K7's limit (256, 256) on its 32-row SIMT tiles, and
    # ragged in-between widths
    (8, 333, 333, 192, 128, 1), (12, 257, 129, 192, 128, 4),
    (6, 130, 257, 256, 256, 2),
    (6, 200, 71, 160, 200, 3), (4, 65, 65, 136, 24, 1),
    # zamba2's head dim 80 (wgmma in bf16): MHA, and ragged both ways
    # with group 4
    (8, 333, 333, 80, 80, 1), (12, 257, 129, 80, 80, 4),
    (8, 330, 200, 80, 80, 4),
    # whisper-tiny's encoder over its 1500 frames (non-causal on its path)
    (24, 1500, 1500, 64, 64, 1),
    # llava's 3904 positions (2880 patches + 1024 tokens), group 4
    (8, 3904, 3904, 128, 128, 4)]
# every shape in f32 (simt) and bf16; a bf16 shape the tensor cores take
# ((D, Dv) in WGMMA_HEAD_DIMS) runs on its design (fused at
# FUSED_HEAD_DIMS, else the three-kernel wgmma one), then forced onto the
# three-kernel design (where the rule names fused) and onto simt
_BWD_DESIGNS = {"fused": ("fused", "wgmma", "simt"),
                "wgmma": ("wgmma", "simt"), "simt": ("simt",)}
_BWD_CASES = [
    (dtype, causal, *shape, variant)
    for dtype in (torch.float32, torch.bfloat16)
    for causal in (True, False)
    for shape in _BWD_SHAPES
    for variant in _BWD_DESIGNS[BK.variant(dtype, shape[3], shape[4])]]


@pytest.mark.parametrize("dtype,causal,BH,Sq,Sk,D,Dv,group,variant",
                         _BWD_CASES)
def test_flash_bwd_matches_plain(cuda, dtype, causal, BH, Sq, Sk, D, Dv,
                                 group, variant):
    """K7 against ``flash_attention_bwd_ref`` on the same inputs (o and
    lse from the plain forward): f32 within 2e-5 of max |grad|; bf16 no
    further from the f32 plain gradient than the bf16 plain gradient is,
    x1.5. Ragged Sq and Sk both ways, D 16/64/128, Dv != D, groups 1/4,
    both variants where bf16 reaches the wgmma kernels; the launch is
    counted under the variant that ran. (A causal query row that sees one
    key has ds = 0 exactly, so its dq is rounding noise that no relative
    measure holds: the shortest case has 3 rows.)"""
    q, k, v, o, lse, do = _bwd_inputs(cuda, BH, Sq, Sk, D, Dv, group, dtype,
                                      causal, BH * Sq + Sk + D)
    before = dict(BK.KERNEL.launches_by_variant)
    forced = None if variant == BK.variant(dtype, D, Dv) else variant
    got = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=group,
                                      causal=causal, force_variant=forced)
    assert BK.KERNEL.launches_by_variant == {
        **before, variant: before[variant] + 1}
    want = FR.flash_attention_bwd_ref(q, k, v, o, lse, do, group=group,
                                      causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
    if dtype == torch.float32:
        assert _grad_err(got, want) <= 2e-5
    else:
        f32 = FR.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), lse, do.float(), group=group,
            causal=causal)
        assert _grad_err(got, f32) <= 1.5 * _grad_err(want, f32)


# (BH, Sq, Sk, group): ragged both ways, and llava's 3904 rows at 4
# heads, where the ping-pong plan cuts items
_OFFSET_SHAPES = [(8, 333, 333, 4), (12, 200, 457, 4), (8, 457, 200, 2),
                  (4, 3904, 3904, 4)]
_OFFSET_CASES = [
    (dtype, D, Dv, variant)
    for dtype in (torch.float32, torch.bfloat16)
    for D, Dv in ((64, 64), (80, 80), (128, 128), (192, 128))
    for variant in (("simt",) if dtype == torch.float32 else
                    ("pingpong", "wgmma", "simt") if D == Dv != 80 else
                    ("wgmma", "simt"))]


def _hold_negative_offset(monkeypatch, q, k, v, do, group, variant, forced,
                          off):
    """``ops.flash_attention`` at a negative offset, forward and backward
    by autograd, with K6 on ``variant`` and K7 on its design beside it
    (the rules, or ``forced`` through both rules): one launch of each, or
    none when no row keeps a key; the output and gradients against the
    same call under ``backend="ref"`` (f32 within 2e-5, of max |grad| for
    the gradients; bf16 within 2e-2 and no further from the f32 plain
    run than the bf16 plain run, x1.5); the key-less rows against the f32
    mean of v."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    n0 = min(-off, Sq)
    design = BK.variant(q.dtype, q.shape[2], v.shape[2])
    if forced is not None:
        monkeypatch.setattr(AK, "variant", lambda *a: forced)
        monkeypatch.setattr(BK, "variant", lambda *a: forced)
        design = forced

    def run(backend, ins, dout):
        ts = [t.detach().clone().requires_grad_() for t in ins]
        o = FA.flash_attention(*ts, group=group, q_offset=off,
                               backend=backend)
        return [o.detach()] + list(torch.autograd.grad(o, ts, dout))
    b6 = dict(AK.KERNEL.launches_by_variant)
    b7 = dict(BK.KERNEL.launches_by_variant)
    got = run(None, (q, k, v), do)
    torch.cuda.synchronize()
    n = int(n0 < Sq)
    assert AK.KERNEL.launches_by_variant == {**b6, variant: b6[variant] + n}
    assert BK.KERNEL.launches_by_variant == {**b7, design: b7[design] + n}
    want = run("ref", (q, k, v), do)
    mean = v.float().sum(1) / Sk
    mean = mean[torch.arange(BH, device=q.device) // group][:, None]
    torch.testing.assert_close(
        got[0][:, :n0].float(), mean.expand(-1, n0, -1), atol=1e-6,
        rtol=0 if q.dtype == torch.float32 else 2 ** -8)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
        assert _grad_err(got[1:], want[1:]) <= 2e-5
        return
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                               atol=2e-2)
    f32 = run("ref", [t.float() for t in (q, k, v)], do.float())
    assert _grad_err(got[1:], f32[1:]) <= 1.5 * _grad_err(want[1:], f32[1:])


@pytest.mark.parametrize("off", [37, 128, 1000, -37, -128, "-Sq"])
@pytest.mark.parametrize("BH,Sq,Sk,group", _OFFSET_SHAPES)
@pytest.mark.parametrize("dtype,D,Dv,variant", _OFFSET_CASES)
def test_flash_attention_offset_matches_plain(cuda, monkeypatch, dtype, D,
                                              Dv, variant, BH, Sq, Sk, group,
                                              off):
    """K6 on each variant and K7 on each design its head dims take (the
    rule's beside K6's rule, else the same one forced), at query offset
    ``off`` (row i keeps keys 0..off + i), against the plain
    versions at the same offset: K6 within 2e-5 (f32) or 2e-2 (bf16), its
    lse within 1e-4; K7 from K6's o and lse, f32 within 2e-5 of max
    |grad|, bf16 no further from the f32 plain gradient than the bf16
    plain one, x1.5; the tensor-core kernels twice, bit for bit. A
    negative offset (-37, -128, -Sq) goes through ``ops.flash_attention``,
    which splits off the rows that keep no key
    (:func:`_hold_negative_offset`)."""
    off = -Sq if off == "-Sq" else off
    q, k, v = _qkv(cuda, BH, Sq, Sk, D, Dv, group, dtype,
                   BH + Sq + abs(off))
    do = torch.randn(BH, Sq, Dv, generator=torch.Generator().manual_seed(
        abs(off))).to(cuda, dtype)
    forced = None if variant == AK.variant(dtype, D, Dv) else variant
    if off < 0:
        _hold_negative_offset(monkeypatch, q, k, v, do, group, variant,
                              forced, off)
        return
    kw = dict(group=group, causal=True, q_offset=off)
    o, lse = AK.flash_attention_cuda(q, k, v, force_variant=forced,
                                     with_lse=True, **kw)
    want, want_lse = FR.flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    # K7's design beside K6's variant: the rule's, or the forced one's
    design = None if forced is None else variant
    got = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                      force_variant=design, **kw)
    grads = FR.flash_attention_bwd_ref(q, k, v, o, want_lse, do, **kw)
    if dtype == torch.float32:
        assert _grad_err(got, grads) <= 2e-5
    else:
        f32 = FR.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), want_lse, do.float(), **kw)
        assert _grad_err(got, f32) <= 1.5 * _grad_err(grads, f32)
    if variant != "simt":
        again = AK.flash_attention_cuda(q, k, v, force_variant=forced,
                                        with_lse=True, **kw)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        twice = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            force_variant=design, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, twice))


@pytest.mark.parametrize("D", [64, 80])         # granite's, zamba2's
@pytest.mark.parametrize("variant", ["simt", "wgmma"])
def test_flash_bwd_is_deterministic(cuda, variant, D):
    """No float atomics: two runs give the same bits, on either
    variant."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 32, 300, 300, D, D, 4,
                                      torch.bfloat16, True, 9)
    before = dict(BK.KERNEL.launches_by_variant)
    a = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=4,
                                    force_variant=variant)
    b = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=4,
                                    force_variant=variant)
    assert BK.KERNEL.launches_by_variant == {
        **before, variant: before[variant] + 2}
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("BH,S,D,group,causal", [
    (12, 1500, 64, 1, False),     # whisper's encoder, 2 x 6 heads
    (16, 3904, 128, 4, True),     # llava's 3904 positions, 4 q heads a kv
    (32, 1024, 64, 4, True),      # granite's training shape, 8 x 4 heads
    (8, 333, 128, 4, False), (12, 200, 64, 1, True)])
def test_flash_bwd_fused_matches_the_other_designs(cuda, BH, S, D, group,
                                                   causal):
    """The fused design (dQ summed inside the dK, dV kernel in key-tile
    order) at whisper's and llava's shapes with fewer heads: launched and
    counted as "fused", no further from the f32 plain gradient than the
    bf16 plain gradient is (x1.5), as are the forced three-kernel and SIMT
    designs on the same inputs; the fused and three-kernel gradients
    differ only in f32 summation orders, so within 2^-7 of max |grad| (two
    bf16 steps at the largest element); and two fused runs give the same
    bits."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, BH, S, S, D, D, group,
                                      torch.bfloat16, causal, BH + S + D)
    assert BK.variant(q.dtype, D, D) == "fused"
    kw = dict(group=group, causal=causal)
    runs = {}
    for name in ("fused", "wgmma", "simt"):
        before = dict(BK.KERNEL.launches_by_variant)
        runs[name] = BK.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, force_variant=None if name == "fused"
            else name, **kw)
        assert BK.KERNEL.launches_by_variant == {
            **before, name: before[name] + 1}
    again = BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = FR.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    f32 = FR.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                     lse, do.float(), **kw)
    torch.cuda.synchronize()
    err_p = _grad_err(want, f32)
    for name, got in runs.items():
        assert all(bool(torch.isfinite(g.float()).all()) for g in got), name
        assert _grad_err(got, f32) <= 1.5 * err_p, name
    assert _grad_err(runs["fused"], runs["wgmma"]) <= 2.0 ** -7
    assert all(torch.equal(a, b) for a, b in zip(runs["fused"], again))


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 16)])
def test_flash_bwd_forced_wgmma_refuses(cuda, dtype, D):
    """A forced "wgmma" on inputs the tensor-core kernels do not take (f32,
    whose 2e-5 contract TF32 would break; bf16 at D = 16) raises and
    launches nothing."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 8, 64, 64, D, D, 4, dtype, True,
                                      5)
    before = dict(BK.KERNEL.launches_by_variant)
    with pytest.raises(ValueError, match="wgmma kernels take bf16"):
        BK.flash_attention_bwd_cuda(q, k, v, o, lse, do, group=4,
                                    force_variant="wgmma")
    assert BK.KERNEL.launches_by_variant == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_on_card(cuda, dtype):
    """``flash_attention`` with inputs that require grad runs K6 (with
    lse) forward and K7 backward (bf16 on K7's fused tensor-core kernels
    at head dim 64, f32 on its simt ones), and its gradients equal autograd through the plain
    version (f32 2e-5 of max |grad|; bf16 by the x1.5 rule against the
    f32 gradient)."""
    q, k, v = _qkv(cuda, 16, 257, 257, 64, 64, 4, dtype, 21)
    g = torch.Generator().manual_seed(22)
    do = torch.randn(16, 257, 64, generator=g).to(cuda, dtype)

    def grads(backend, cast=None):
        leaves = [(t if cast is None else t.to(cast)).detach()
                  .requires_grad_() for t in (q, k, v)]
        out = FA.flash_attention(*leaves, group=4, backend=backend)
        out.backward(do if cast is None else do.to(cast))
        return out, [t.grad for t in leaves]

    b6, b7 = AK.KERNEL.launches, BK.KERNEL.launches
    by_variant = dict(BK.KERNEL.launches_by_variant)
    out, got = grads(None)
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (b6 + 1, b7 + 1)
    ran = "fused" if dtype == torch.bfloat16 else "simt"
    assert BK.variant(dtype, 64, 64) == ran
    assert BK.KERNEL.launches_by_variant == {
        **by_variant, ran: by_variant[ran] + 1}
    ref_out, want = grads("ref")
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (b6 + 1, b7 + 1)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=ATT_TOL[dtype], atol=ATT_TOL[dtype])
    if dtype == torch.float32:
        assert _grad_err(got, want) <= 2e-5
    else:
        _, f32 = grads("ref", torch.float32)
        assert _grad_err(got, f32) <= 1.5 * _grad_err(want, f32)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_train_step_kernels_equal_plain(cuda, remat):
    """One REDUCED granite train step (f32) on the card through K6 and K7
    against the same step with the plain versions: loss 1e-5 relative,
    every gradient leaf 1e-4 of its largest element, the gradient norm
    1e-4 relative, the updated parameters within 1e-2 of the learning
    rate. K6 launches once per layer (twice under remat: the backward
    recomputes each block), K7 once per layer."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    cfg = get_config("granite-3-2b", reduced=True).replace(
        dtype="float32", param_dtype="float32", remat=remat)
    model = Model(cfg, device=cuda)
    plain = Model(cfg, device=cuda, backend="ref")
    params = model.init(0)
    batch = DATA.batch_at(0, cfg, 4, 100, device=cuda)
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    loss, grads = ST.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert AK.KERNEL.launches == (2 * L if remat == "full" else L)
    assert BK.KERNEL.launches == L
    ploss, pgrads = ST.loss_and_grads(plain, params, batch)
    assert BK.KERNEL.launches == L
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))

    def close(a, b, tol, what):
        for x, y in zip(adamw.leaves(a), adamw.leaves(b)):
            err = float((x.float() - y.float()).abs().max())
            assert err <= tol * float(y.float().abs().max()), what
    close(grads, pgrads, 1e-4, "grads")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, donate_state=False)
    states = [{"params": params, "opt": adamw.init(params, tcfg)}
              for _ in range(2)]
    got, gm = ST.make_train_step(model, tcfg)(states[0], batch)
    want, wm = ST.make_train_step(plain, tcfg)(states[1], batch)
    # Adam's first update is near sign(g) * lr for every element: hold the
    # parameters to a hundredth of the step size
    for x, y in zip(adamw.leaves(got["params"]), adamw.leaves(want["params"])):
        assert float((x - y).abs().max()) <= 1e-2 * tcfg.learning_rate
    assert abs(float(gm["gnorm"]) - float(wm["gnorm"])) <= \
        1e-4 * float(wm["gnorm"])


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_reduced_moe_train_step_kernels_equal_plain(cuda, arch):
    """One REDUCED moe-family loss and gradient (f32; deepseek-v3 with MLA
    at D = 24, Dv = 16 and its MTP block) on the card through K6 and K7
    against the plain versions: loss 1e-5 relative, every gradient leaf
    1e-4 of its largest element (the top-1 router of llama4-scout, whose
    gradient is 0 up to rounding, of the tree's largest element). K6
    and K7 launch once per layer and once for the MTP block."""
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    model = Model(cfg, device=cuda)
    params = model.init(0)
    batch = DATA.batch_at(0, cfg, 4, 100, device=cuda)
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    loss, grads = ST.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    n = cfg.num_layers + (1 if cfg.mtp_depth else 0)
    assert AK.KERNEL.launches == BK.KERNEL.launches == n
    ploss, pgrads = ST.loss_and_grads(Model(cfg, device=cuda, backend="ref"),
                                      params, batch)
    assert BK.KERNEL.launches == n
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    top = max(float(g.abs().max()) for g in adamw.leaves(pgrads))
    for path, x, y in zip(adamw.paths(grads), adamw.leaves(grads),
                          adamw.leaves(pgrads)):
        scale = (top if cfg.moe.top_k == 1 and path[-1] == "router"
                 else float(y.abs().max()))
        assert float((x - y).abs().max()) <= 1e-4 * scale, path


def test_reduced_hybrid_train_step_kernels_equal_plain(cuda):
    """One REDUCED zamba2 loss and gradient (f32, remat on) on the card
    through K6 and K7 against the plain versions: loss 1e-5 relative,
    every gradient leaf 1e-4 of its largest element. K6 launches twice
    per shared-block call (the forward and its recomputation) and K7
    once: each of the 2 segments calls one."""
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    cfg = get_config("zamba2-2.7b", reduced=True).replace(
        dtype="float32", param_dtype="float32", remat="full")
    model = Model(cfg, device=cuda)
    params = model.init(0)
    batch = DATA.batch_at(0, cfg, 4, 100, device=cuda)
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    loss, grads = ST.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (4, 2)
    ploss, pgrads = ST.loss_and_grads(Model(cfg, device=cuda, backend="ref"),
                                      params, batch)
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (4, 2)
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    for path, x, y in zip(adamw.paths(grads), adamw.leaves(grads),
                          adamw.leaves(pgrads)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), \
            path


def test_reduced_hybrid_serving_kernels_equal_plain(cuda):
    """REDUCED zamba2 in f32 on the card: a 100-token prefill (K6 once per
    segment) and 3 greedy decode steps, the plain run fed the kernel run's
    tokens; logits within 1e-5 of the plain run's largest logit, and
    every Mamba2 state and K/V leaf of the cache within 1e-5 of its
    largest element."""
    from repro_torch.launch.serve import build_cache
    cfg = get_config("zamba2-2.7b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    params = Model(cfg, device=cuda).init(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 100),
                           generator=torch.Generator().manual_seed(2)).to(cuda)

    def run(model, forced=None):
        AK.KERNEL.reset_counts()
        logits, pcache = model.prefill(params, {"tokens": tokens})
        launched = AK.KERNEL.launches
        cache = build_cache(model, pcache, 4, 112)
        seen, toks = [logits], []
        pos = torch.full((4,), 100, device=cuda)
        for i in range(3):
            toks.append(logits.argmax(-1)[:, None] if forced is None
                        else forced[i])
            logits, cache = model.decode(params, toks[-1], pos, cache)
            seen.append(logits)
            pos = pos + 1
        return seen, toks, cache, launched

    got, toks, cache, launched = run(Model(cfg, device=cuda))
    want, _, pcache, plain_launched = run(
        Model(cfg, device=cuda, backend="ref"), toks)
    assert (launched, plain_launched) == (2, 0)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for seg, pseg in zip(cache, pcache):
        pairs = [(seg[n], pseg[n]) for n in ("attn_k", "attn_v")] + [
            (seg["mamba"][n], pseg["mamba"][n]) for n in seg["mamba"]]
        for x, y in pairs:
            assert float((x - y).abs().max()) <= 1e-5 * float(
                y.abs().max())


def test_reduced_rwkv_serving_matches_cpu(cuda):
    """REDUCED rwkv6 in f32 on the card against the CPU's run of the same
    parameters: a 100-token prefill (chunks of 25) and 3 greedy decode
    steps, the CPU run fed the card's tokens; logits within 1e-4 of the
    CPU's largest logit, every state leaf within 1e-4 of its largest
    element, and no kernel launches (the family has no attention)."""
    from repro_torch.launch.serve import build_cache
    from repro_torch.optim import adamw
    cfg = get_config("rwkv6-3b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    params = Model(cfg, device=cuda).init(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 100),
                           generator=torch.Generator().manual_seed(2))

    def run(device, forced=None):
        model = Model(cfg, device=device)
        p = adamw.tree_map(lambda t: t.to(device), params)
        logits, pcache = model.prefill(p, {"tokens": tokens.to(device)})
        cache = build_cache(model, pcache, 4, 112)
        seen, toks = [logits], []
        pos = torch.full((4,), 100, device=device)
        for i in range(3):
            toks.append(logits.argmax(-1)[:, None] if forced is None
                        else forced[i].to(device))
            logits, cache = model.decode(p, toks[-1], pos, cache)
            seen.append(logits)
            pos = pos + 1
        return seen, toks, cache

    AK.KERNEL.reset_counts()
    got, toks, cache = run(cuda)
    assert AK.KERNEL.launches == 0
    want, _, ccache = run(torch.device("cpu"), toks)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    for n, x in cache.items():
        y = ccache[n]
        assert float((x.cpu() - y).abs().max()) <= 1e-4 * float(
            y.abs().max()), n


def _whisper_batch(cfg, cuda, B, S, seed):
    from repro_torch.data import tokens as DATA
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed))
    return DATA.add_modality_stub({"tokens": tokens.to(cuda)}, cfg, seed)


def test_reduced_whisper_serving_kernels_equal_plain(cuda):
    """REDUCED whisper in f32 on the card: a 40-token prefill over 32 stub
    frames (K6 twice without a mask, the encoder, and twice causal, the
    decoder) and 3 greedy decode steps, the plain run fed the kernel
    run's tokens; logits within 1e-5 of the plain run's largest logit, and
    every k, v, xk, xv leaf of the cache within 1e-5 of its largest
    element."""
    from repro_torch.launch.serve import build_cache
    cfg = get_config("whisper-tiny", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    params = Model(cfg, device=cuda).init(1)
    batch = _whisper_batch(cfg, cuda, 4, 40, 2)

    def run(model, forced=None):
        AK.KERNEL.reset_counts()
        logits, pcache = model.prefill(params, batch)
        launched = dict(AK.KERNEL.launches_by_kind)
        cache = build_cache(model, pcache, 4, 48)
        seen, toks = [logits], []
        pos = torch.full((4,), 40, device=cuda)
        for i in range(3):
            toks.append(logits.argmax(-1)[:, None] if forced is None
                        else forced[i])
            logits, cache = model.decode(params, toks[-1], pos, cache)
            seen.append(logits)
            pos = pos + 1
        return seen, toks, cache, launched

    got, toks, cache, launched = run(Model(cfg, device=cuda))
    want, _, pcache, plain_launched = run(
        Model(cfg, device=cuda, backend="ref"), toks)
    assert launched == {"causal": 2, "full": 2}
    assert plain_launched == {"causal": 0, "full": 0}
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for layer, player in zip(cache, pcache):
        for n in ("k", "v", "xk", "xv"):
            x, y = layer[n], player[n]
            assert float((x - y).abs().max()) <= 1e-5 * float(
                y.abs().max()), n


def test_reduced_whisper_train_step_kernels_equal_plain(cuda):
    """One REDUCED whisper loss and gradient (f32, remat on) on the card
    through K6 and K7 against the plain versions: loss 1e-5 relative,
    every gradient leaf 1e-4 of its largest element. K6 launches once per
    encoder layer without a mask and twice per decoder layer causal (the
    forward and its recomputation); K7 once per layer of each."""
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    cfg = get_config("whisper-tiny", reduced=True).replace(
        dtype="float32", param_dtype="float32", remat="full")
    model = Model(cfg, device=cuda)
    params = model.init(0)
    batch = DATA.add_modality_stub(DATA.batch_at(0, cfg, 4, 100,
                                                 device=cuda), cfg, 0)
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    loss, grads = ST.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    kinds = (AK.KERNEL.launches_by_kind, BK.KERNEL.launches_by_kind)
    assert kinds == ({"causal": 4, "full": 2}, {"causal": 2, "full": 2})
    ploss, pgrads = ST.loss_and_grads(Model(cfg, device=cuda, backend="ref"),
                                      params, batch)
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (6, 4)
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    for path, x, y in zip(adamw.paths(grads), adamw.leaves(grads),
                          adamw.leaves(pgrads)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), \
            path


def _vlm_batch(cfg, cuda, B, S, seed):
    """Random tokens on the card and the stub patches of step ``seed``."""
    from repro_torch.data import tokens as DATA
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed))
    return DATA.add_modality_stub({"tokens": tokens.to(cuda)}, cfg, seed)


def test_reduced_vlm_serving_kernels_equal_plain(cuda):
    """REDUCED llava in f32 on the card: a prefill over 16 stub patches + 40
    tokens (K6 once per layer, causal, over 56 positions) and 3 greedy
    decode steps from position 56, the plain run fed the kernel run's
    tokens; logits within 1e-5 of the plain run's largest logit, every k, v
    leaf of the cache within 1e-5 of its largest element; the last step
    equals a full forward over the patches and 43 tokens within 1e-4."""
    from repro_torch.launch.serve import build_cache
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    cfg = get_config("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    params = Model(cfg, device=cuda).init(1)
    batch = _vlm_batch(cfg, cuda, 4, 40, 2)
    n = cfg.vision.num_patches + 40

    def run(model, forced=None):
        AK.KERNEL.reset_counts()
        logits, pcache = model.prefill(params, batch)
        launched = dict(AK.KERNEL.launches_by_kind)
        cache = build_cache(model, pcache, 4, n + 8)
        seen, toks = [logits], []
        pos = torch.full((4,), n, device=cuda)
        for i in range(3):
            toks.append(logits.argmax(-1)[:, None] if forced is None
                        else forced[i])
            logits, cache = model.decode(params, toks[-1], pos, cache)
            seen.append(logits)
            pos = pos + 1
        return seen, toks, cache, launched

    got, toks, cache, launched = run(Model(cfg, device=cuda))
    want, _, pcache, plain_launched = run(
        Model(cfg, device=cuda, backend="ref"), toks)
    assert launched == {"causal": 2, "full": 0}
    assert plain_launched == {"causal": 0, "full": 0}
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for layer, player in zip(cache, pcache):
        for name in ("k", "v"):
            x, y = layer[name], player[name]
            assert float((x - y).abs().max()) <= 1e-5 * float(
                y.abs().max()), name
    full = {"patches": batch["patches"],
            "tokens": torch.cat([batch["tokens"]] + toks, 1)}
    h = LM.lm_hidden(params, full, cfg)
    last = L.logits_fn(params["embed"], h[:, -1:], False)[:, 0]
    assert float((got[-1] - last).abs().max()) <= 1e-4 * float(
        last.abs().max())


def test_reduced_vlm_train_step_kernels_equal_plain(cuda):
    """One REDUCED llava loss and gradient (f32, remat on) on the card over
    16 stub patches + 100 tokens, through K6 and K7 against the plain
    versions: loss 1e-5 relative, every gradient leaf 1e-4 of its largest
    element; K6 twice per layer (the forward and its recomputation), K7
    once, all causal."""
    from repro_torch.data import tokens as DATA
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    cfg = get_config("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32", param_dtype="float32", remat="full")
    model = Model(cfg, device=cuda)
    params = model.init(0)
    batch = DATA.add_modality_stub(DATA.batch_at(0, cfg, 4, 100,
                                                 device=cuda), cfg, 0)
    AK.KERNEL.reset_counts()
    BK.KERNEL.reset_counts()
    loss, grads = ST.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    kinds = (AK.KERNEL.launches_by_kind, BK.KERNEL.launches_by_kind)
    assert kinds == ({"causal": 4, "full": 0}, {"causal": 2, "full": 0})
    ploss, pgrads = ST.loss_and_grads(Model(cfg, device=cuda, backend="ref"),
                                      params, batch)
    assert (AK.KERNEL.launches, BK.KERNEL.launches) == (4, 2)
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    for path, x, y in zip(adamw.paths(grads), adamw.leaves(grads),
                          adamw.leaves(pgrads)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), \
            path


def test_compression_and_pipeline_on_card_equal_cpu(cuda):
    """``compressed_psum`` over 4 emulated ranks on the card equals the
    CPU's bit for bit (means and residuals), and ``pipeline_apply`` of
    REDUCED llava blocks (f32, 2 per stage) on a (2, 2) ("pod", "data")
    mesh on the card equals the blocks applied per microbatch bit for bit,
    launching K6 2 x 2 x 2 x 2 = 16 times."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import EmulatedMesh
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as C
    g = torch.Generator().manual_seed(4)
    grads = {"w": torch.randn(4, 33, 65, generator=g) * 0.01,
             "b": torch.randn(4, 7, generator=g)}
    err = adamw.tree_map(lambda t: torch.randn(t.shape, generator=g) * 1e-4,
                         grads)
    axes = ("pod", "data")
    outs = [C.compressed_psum(adamw.tree_map(lambda t: t.to(d), grads),
                              adamw.tree_map(lambda t: t.to(d), err),
                              EmulatedMesh(axes, (2, 2), torch.device(d)),
                              axes) for d in (cuda, "cpu")]
    for a, b in zip(*(adamw.leaves(o[0]) + adamw.leaves(o[1]) for o in outs)):
        assert torch.equal(a.cpu(), b)
    cfg = get_config("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32", param_dtype="float32", num_layers=4)
    stack = Model(cfg, device=cuda).init(3)["stack_0_dense"]
    staged = adamw.tree_map(lambda a: a.reshape(2, 2, *a.shape[1:]), stack)
    x = torch.randn(8, 40, cfg.d_model, generator=g).to(cuda)

    def blocks(h, p, n):
        for lp in LM.unstack(p, n):
            h = LM.block_train(lp, h, cfg)
        return h

    AK.KERNEL.reset_counts()
    with torch.no_grad():
        got = pipeline_apply(lambda p, h, s: blocks(h, p, 2), staged, x,
                             EmulatedMesh(axes, (2, 2), cuda), num_micro=2)
        assert AK.KERNEL.launches == 16
        each = torch.cat([blocks(m, stack, 4) for m in x.split(2)])
    assert torch.equal(got, each)


# -- the serving slice on the card ---------------------------------------------

def test_host_ingest_ring_stages_from_pinned_memory(cuda):
    """Pinned slots copied on the ring's own stream; the staged tensors
    equal the batch; a slot's pinned buffers are not refilled while the
    step that reads them is in flight (its event has to complete)."""
    from repro_torch.launch.serving import HostIngestRing
    N = 1 << 16
    ring = HostIngestRing(cuda, N)
    assert ring.copy_stream != torch.cuda.current_stream(cuda)
    assert all(t.is_pinned() for slot in ring._host for t in slot.values())
    rng = np.random.default_rng(0)
    staged = []
    for p in range(4):
        views = ring.host_slot()
        if p >= 2:       # the step that read this slot two periods ago
            assert ring._consumed[p & 1].query()
        batch = {"ts": rng.integers(0, 1 << 32, N, dtype=np.uint64
                                    ).astype(np.uint32),
                 "size": rng.integers(0, 1 << 32, N, dtype=np.uint64
                                      ).astype(np.uint32),
                 "five_tuple": rng.integers(0, 1 << 32, (N, 5),
                                            dtype=np.uint64).astype(np.uint32),
                 "valid": rng.random(N) < 0.5}
        for k in views:
            views[k][...] = batch[k]
        ev, now = ring.stage(views, np.uint32(20_000 * (p + 1)))
        # a long kernel on the compute stream stands in for the step
        torch.cuda._sleep(20_000_000)
        got = {k: v.clone() for k, v in ev.items()}
        ring.consumed()
        pending = ring._consumed[p & 1]
        assert not pending.query(), "the step's event completed too early"
        staged.append((batch, got, int(now)))
    torch.cuda.synchronize()
    for p, (batch, got, now) in enumerate(staged):
        assert now == 20_000 * (p + 1)
        for k in batch:
            want = (torch.from_numpy(batch[k]) if k == "valid"
                    else U.from_numpy(batch[k]))
            assert torch.equal(got[k].cpu(), want), (p, k)


def test_serving_loop_kernels_equal_plain_on_card(cuda, tmp_path):
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.launch.serving import ServingLoop, build_source
    cfg = dataclasses.replace(REDUCED, wire_format="v2",
                              inference_head="mlp",
                              snapshot_every_periods=3)
    events, nows = PK.period_batches(1, 3, cfg.event_block, n_flows=40,
                                     flow_seed=1)
    reports = {}
    for backend in ("auto", "ref"):
        system = DFASystem(dataclasses.replace(cfg, kernel_backend=backend),
                           device=cuda)
        loop = ServingLoop(system, build_source(system, events, nows),
                           snapshot_dir=str(tmp_path / backend))
        reports[backend] = loop.run(7)
    a, b = reports["auto"], reports["ref"]
    assert a.balanced and b.balanced and a.snapshots == 3
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k]), k
    for x, y in zip(state_to_numpy(a.last.state), state_to_numpy(b.last.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    restored, step = C.restore(str(tmp_path / "auto"), device=cuda)
    assert step == 7
    assert restored.collector.memory.device.type == "cuda"
    for x, y in zip(state_to_numpy(restored), state_to_numpy(a.last.state)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_checkpoint_cuda_state_to_cuda(cuda, tmp_path):
    from repro_torch.checkpoint import checkpoint as C
    system = DFASystem(REDUCED, device=cuda)
    events, nows = PK.period_batches(1, 2, 256, n_flows=30, device=cuda)
    live = system.run_periods(system.init_state(), events, nows).state
    C.save({"state": live, "bf16": torch.ones(3, dtype=torch.bfloat16,
                                               device=cuda)},
           str(tmp_path), step=2)
    got, _ = C.restore(str(tmp_path), device=cuda)
    assert got["bf16"].device.type == "cuda"
    assert got["bf16"].dtype == torch.bfloat16
    for x, y in zip(state_to_numpy(got["state"]), state_to_numpy(live)):
        for f in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


# -- elastic pod loss and join on the card --------------------------------------

ELASTIC = dict(flow_home="rendezvous", reporter_slots=64, flows_per_shard=512,
               port_report_capacity=16, snapshot_every_periods=2,
               rehome_collision_policy="warn")


def elastic_system(pods, nodes, device, **kw):
    cfg = dataclasses.replace(REDUCED, pods=pods, ports_per_pod=4 // pods,
                              home_nodes=nodes, **{**ELASTIC, **kw})
    return DFASystem(cfg, device=device, n_shards=2 * pods)


def keys_won_by(nodes, want):
    """Five-tuples (numpy u32) whose HRW winners over ``nodes`` are the
    positions ``want``, in order."""
    from repro_torch.core import translator as TT
    node_ids = torch.tensor(nodes, dtype=torch.int64)
    i = torch.arange(1, 1 << 14, dtype=torch.int64)
    keys = torch.stack([i, i + 1, torch.full_like(i, 7),
                        torch.full_like(i, 9), torch.full_like(i, 11)], 1)
    pos = TT.rendezvous_position(TR.hash_u32(keys), node_ids)
    return [keys[int(torch.nonzero(pos == w)[k])].numpy().astype(np.uint32)
            for k, w in enumerate(want)]


def planted(state, wf, fps, rows):
    """``state`` (CPU) with ring rows planted: {global row: [(entry,
    key), ...]}, random words around each key."""
    rng = np.random.default_rng(0)
    mem = state.collector.memory.clone()
    ev = state.collector.entry_valid.clone()
    for row, entries in rows.items():
        for h, key in entries:
            words = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
            words = words.astype(np.uint32)
            words[wf.payload_tuple_slice] = key
            mem[row, h] = U.from_numpy(words)
            ev[row, h] = True
    return state._replace(collector=state.collector._replace(
        memory=mem, entry_valid=ev))


def test_rehome_and_expand_on_card_equal_cpu(cuda):
    """The vectorised state moves give on the card what they give on the
    CPU (state bit for bit, RehomeStats), planted unsplittable rows and two
    source rows on one destination row included."""
    import warnings
    from repro_torch.data import scenarios as SC
    from repro_torch.launch import elastic as EL
    ev, nows = SC.build("cross_pod_mix", 4, 48, 4)
    tev = {k: (torch.from_numpy(v) if k == "valid" else U.from_numpy(v))
           for k, v in ev.items()}
    tnows = torch.from_numpy(nows.astype(np.int64))
    full, surv = (elastic_system(2, (0, 1, 2, 3), "cpu"),
                  elastic_system(1, (2, 3), "cpu"))
    small = elastic_system(1, (0, 1), "cpu")
    fps, wf = 512, full.wire
    a, b = keys_won_by((2, 3), [0, 1])
    c, d = keys_won_by((2, 3), [1, 1])
    st = planted(full.run_periods(full.init_state(), tev, tnows).state, wf,
                 fps, {5: [(0, a), (3, b)], 9: [(2, c), (4, c)],
                       fps + 9: [(1, d), (2, d)]})
    e, f = keys_won_by((0, 1, 2, 3), [0, 2])
    g, h = keys_won_by((0, 1, 2, 3), [3, 3])
    st_small = planted(small.run_periods(small.init_state(), tev,
                                         tnows).state, wf, fps,
                       {11: [(0, e), (7, f)], 13: [(0, g), (5, g)],
                        fps + 13: [(5, h), (9, h)]})
    on_card = lambda s: type(s)(*(type(x)(*(y.to(cuda) for y in x))
                                  for x in s))
    for fn, state, args in (("rehome_state", st, (full, surv, 0)),
                            ("expand_state", st_small, (small, full))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want, wstats = getattr(EL, fn)(state, *args)
            got, gstats = getattr(EL, fn)(on_card(state), *args)
        assert tuple(gstats) == tuple(wstats) and wstats.moved_rows > 0
        assert wstats.unsplittable_collisions == 1
        assert got.collector.memory.device.type == cuda.type
        for x, y in zip(state_to_numpy(got), state_to_numpy(want)):
            for name in type(x)._fields:
                np.testing.assert_array_equal(getattr(x, name),
                                              getattr(y, name),
                                              err_msg=f"{fn} {name}")


def test_live_recovery_on_card_equals_offline(cuda, tmp_path):
    """A REDUCED (2,2) ServingLoop on the card, with the kernels, loses pod
    0 one period past a snapshot: the journal re-assembles the replayed
    batch from its recipe (the pinned slot it was staged from has been
    refilled since), and the final state equals the offline recovery on
    the card bit for bit."""
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.data import scenarios as SC
    from repro_torch.launch import elastic as EL
    from repro_torch.launch.serving import (ServingLoop, build_source,
                                            host_tensors)
    ev, nows = SC.build("cross_pod_mix", 4, 48, 6)
    kill_at, T = 5, 8
    full = elastic_system(2, (), cuda, rehome_collision_policy="fail")
    loop = ServingLoop(full, build_source(full, ev, nows),
                       snapshot_dir=str(tmp_path / "live"),
                       chaos=lambda t: [0] if t == kill_at else [])
    assert loop.ring.on_card == (cuda.type == "cuda")
    report = loop.run(T)
    assert (report.recoveries, report.journal_replayed) == (1, 1)
    assert loop.system.device.type == cuda.type and report.balanced
    src = build_source(full, ev, nows)
    batches = [src.next_batch()[:2] for _ in range(T)]

    def step(system, state, b, now):
        e, n = host_tensors(b, now)
        return system.dfa_step(state, {k: v.to(cuda) for k, v in e.items()},
                               n.to(cuda)).state

    state = full.init_state()
    for b, now in batches[:4]:
        state = step(full, state, b, now)
    C.save(state, str(tmp_path / "off"), step=4)
    new, state, period = EL.recover_from_snapshot(full, str(tmp_path / "off"),
                                                  0)
    assert period == 4 and new.device.type == cuda.type
    for b, now in batches[4:]:
        state = step(new, state, b, now)
    for x, y in zip(state_to_numpy(report.last.state), state_to_numpy(state)):
        for name in type(x)._fields:
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name),
                                          err_msg=name)
