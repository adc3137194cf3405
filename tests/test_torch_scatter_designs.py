"""The algorithms of the CUDA kernels K4 ``flow_moments`` and K2
``ring_scatter``, modelled in numpy and held against the plain versions
and the JAX reference on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against their plain versions there). What these tests hold is
the argument each design rests on:

* K4 puts whole events on the lanes of a warp (4 events x 7 registers
  on lanes 0-27) and adds each non-zero delta with one 32-bit atomic.
  The model maps every thread of the grid to its (event, register) item
  as the kernel does, checks that each item has exactly one lane, and
  runs the adds in random orders on registers near 2^32: the result is
  always the mod-2^32 sums, ``flow_moments_ref`` of both packages;
* K2 splits the cells between G blocks by a multiplicative hash; each
  block walks the rows in rounds of C, elects each of its cells' last
  masked row in an open-addressing table of 2C entries and writes the
  winners. The model runs the blocks in random order and the rows of a
  round in random order: the ring always equals ``ring_scatter_ref`` and
  ``ring_scatter_pallas(interpret=True)`` with the reference's
  entry_valid update;
* the wrappers refuse, before any launch, what the kernels cannot take.

Integers bit for bit.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flow_moments.ref import flow_moments_ref as jax_moments
from repro.kernels.ring_scatter.kernel import ring_scatter_pallas
from repro.kernels.ring_scatter.ops import ring_scatter_collector
from repro_torch.kernels.flow_moments.ref import flow_moments_ref
from repro_torch.kernels.ring_scatter import kernel as RK
from repro_torch.kernels.ring_scatter.ref import ring_scatter_ref
from test_torch_leaves import T, assert_same, rand_u32

CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "csrc")
M32 = (1 << 32) - 1
OWNER_MUL, SLOT_MUL = 0x9E3779B1, 0x85EBCA6B     # csrc/ring_scatter.cu


def cu_constant(name):
    """An ``int`` constant of csrc/ring_scatter.cu."""
    with open(os.path.join(CSRC, "ring_scatter.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


K_BLOCKS, K_ROUND = cu_constant("kBlocks"), cu_constant("kMaxRound")


# -- K4: 32-bit adds on lanes of whole events ----------------------------------

EVENTS_PER_WARP, LANES = 4, 28                   # csrc/flow_moments.cu
THREADS = 256


def lane_items(E):
    """The (event, register) item each (block, thread) of K4's grid takes,
    as the kernel computes it; None for an idle lane or one past E."""
    per_block = THREADS // 32 * EVENTS_PER_WARP
    items = []
    for b in range(-(-E // per_block)):
        for t in range(THREADS):
            lane = t & 31
            if lane >= LANES:
                items.append(None)
                continue
            e = b * per_block + (t >> 5) * EVENTS_PER_WARP + lane // 7
            items.append((e, lane % 7) if e < E else None)
    return items


def lane_adds(slots, deltas, valid, F):
    """The 32-bit atomic adds K4 issues: (word, value) with word 7 s + c
    of the flat (F * 7) registers, one per non-zero delta of a valid
    event whose slot lies in [0, F)."""
    adds = []
    for item in lane_items(len(slots)):
        if item is None:
            continue
        e, c = item
        s, d = int(slots[e]), int(deltas[e, c])
        if valid[e] and 0 <= s < F and d:
            adds.append((7 * s + c, d))
    return adds


def run_adds(regs, adds, rng):
    """Apply the adds to a copy of the flat u32 registers in a random
    order, each mod 2^32 on its own."""
    mem = [int(x) for x in regs.reshape(-1)]
    for i in rng.permutation(len(adds)):
        w, v = adds[i]
        mem[w] = (mem[w] + v) & M32
    return np.array(mem, np.uint64).astype(np.uint32).reshape(regs.shape)


def moments_case(rng, case, F, E):
    regs = rand_u32(rng, (F, 7))
    slots = rng.integers(0, F + 2, E)            # some past the end
    deltas = rand_u32(rng, (E, 7))
    deltas[rng.random((E, 7)) < 0.25] = 0
    valid = rng.random(E) < 0.9
    if case == "near 2^32":            # registers at 0xFFFFFFF0: wraps
        regs[:] = 0xFFFFFFF0
    if case == "one odd slot":
        slots[:] = F - 2 if (F - 2) & 1 else F - 1
    if case == "small deltas":         # the trace's shape: few wraps
        deltas &= 0xFFF
    return regs, slots, deltas, valid


def mod_sums(regs, slots, deltas, valid, F):
    out = regs.astype(np.uint64)
    ok = valid & (slots >= 0) & (slots < F)
    np.add.at(out, slots[ok], deltas[ok].astype(np.uint64))
    return (out & M32).astype(np.uint32)


def test_lanes_cover_every_item_once():
    """Every (event, register) item of E events falls on exactly one lane
    of the grid, whole events per warp, at E that fills no block."""
    for E in (1, 4, 31, 32, 33, 100):
        items = lane_items(E)
        got = sorted(i for i in items if i is not None)
        assert got == [(e, c) for e in range(E) for c in range(7)]
        for w in range(0, len(items), 32):      # one warp: whole events
            events = {i[0] for i in items[w:w + 32] if i is not None}
            for e in events:
                assert sum(1 for i in items[w:w + 32]
                           if i is not None and i[0] == e) == 7


@pytest.mark.parametrize("F", [9, 16])
@pytest.mark.parametrize("case", ["random", "near 2^32", "one odd slot",
                                  "small deltas"])
def test_lane_adds_equal_the_mod_sums_in_any_order(rng, case, F):
    E = 150
    regs, slots, deltas, valid = moments_case(rng, case, F, E)
    want = mod_sums(regs, slots, deltas, valid, F)
    assert_same(want, flow_moments_ref(T(regs), torch.from_numpy(slots),
                                       T(deltas), T(valid)))
    assert_same(want, jax_moments(jnp.asarray(regs),
                                  jnp.asarray(slots.astype(np.int32)),
                                  jnp.asarray(deltas), jnp.asarray(valid)))
    adds = lane_adds(slots, deltas, valid, F)
    live = valid & (slots >= 0) & (slots < F)
    assert len(adds) == int((deltas[live] != 0).sum())  # zeros issue none
    for _ in range(8):
        assert_same(want, run_adds(regs, adds, rng))


# -- K2: cell partitions, rounds, shared election ----------------------------

def owner(cell, G):
    return ((cell * OWNER_MUL) & M32) * G >> 32


def scatter_model(mem, ev, pays, flow, hist, mask, G, C, rng):
    """K2's algorithm: blocks in random order, each walking the rows in
    rounds of C (rows of a round inserted in random order); returns the
    updated copies of the ring and validity."""
    F, H, _ = mem.shape
    mem, ev = mem.copy(), ev.copy()
    R = len(flow)
    size = 2 * C
    bits = size.bit_length() - 1
    for b in rng.permutation(G):
        for base in range(0, R, C):
            keys = np.full(size, -1, np.int64)
            rows = np.full(size, -1, np.int64)
            listed = []
            for r in base + rng.permutation(min(C, R - base)):
                f, h = int(flow[r]), int(hist[r])
                if not mask[r] or not (0 <= f < F and 0 <= h < H):
                    continue
                cell = f * H + h
                if owner(cell, G) != b:
                    continue
                slot = ((cell * SLOT_MUL) & M32) >> (32 - bits)
                while keys[slot] not in (-1, cell):
                    slot = (slot + 1) & (size - 1)
                if keys[slot] == -1:
                    keys[slot] = cell
                    listed.append(slot)
                rows[slot] = max(rows[slot], r)
            assert len(listed) <= C         # the table is at most half full
            for slot in listed:
                f, h = divmod(int(keys[slot]), H)
                mem[f, h] = pays[rows[slot]]
                ev[f, h] = True
    return mem, ev


def scatter_case(rng, R, n_cells, F, H):
    mem = rand_u32(rng, (F, H, 16))
    ev = rng.random((F, H)) < 0.3
    pays = rand_u32(rng, (R, 16))
    if n_cells:                              # few cells, many writers
        cell = rng.integers(0, n_cells, R)
        flow, hist = (cell * 37) % F, cell % H
    else:
        flow, hist = rng.integers(0, F, R), rng.integers(0, H, R)
    flow[rng.random(R) < 0.05] = F + 3       # outside the ring
    hist[rng.random(R) < 0.05] = -1
    mask = rng.random(R) < 0.8
    return mem, ev, pays, flow, hist, mask


def test_model_hashes_are_the_kernels():
    with open(os.path.join(CSRC, "ring_scatter.cu")) as f:
        src = f.read()
    assert f"cell * 0x{OWNER_MUL:X}u" in src
    assert f"* 0x{SLOT_MUL:X}u" in src
    assert K_ROUND & (K_ROUND - 1) == 0 and K_ROUND >= 1024  # a power of 2
    assert 1 <= K_BLOCKS <= 132                              # one per SM


@pytest.mark.parametrize("G", [1, 3, K_BLOCKS])
@pytest.mark.parametrize("C,R,n_cells", [(8, 4 * 8 + 17, 5), (16, 100, 0),
                                         (64, 64, 2)])
def test_partitioned_rounds_equal_last_write_wins(rng, G, C, R, n_cells):
    F, H = 64, 4
    mem, ev, pays, flow, hist, mask = scatter_case(rng, R, n_cells, F, H)
    want_m, want_ev = ring_scatter_ref(T(mem), T(ev), T(pays),
                                       torch.from_numpy(flow),
                                       torch.from_numpy(hist), T(mask))
    # the reference never sees rows outside the ring (its collector
    # clamps them), so they are masked out for it; the port skips them
    inside = mask & (flow >= 0) & (flow < F) & (hist >= 0) & (hist < H)
    j = [jnp.asarray(a) for a in (mem, ev, pays, flow.astype(np.int32),
                                  hist.astype(np.int32), inside)]
    jm = ring_scatter_pallas(j[0], *j[2:], flow_tile=64, history=H,
                             interpret=True)
    _, jev = ring_scatter_collector(*j, backend="ref")
    assert_same(jm, want_m)
    assert_same(jev, want_ev)
    for _ in range(3):
        got_m, got_ev = scatter_model(mem, ev, pays, flow, hist, mask, G, C,
                                      rng)
        assert_same(jm, got_m)
        assert_same(jev, got_ev)


def test_partitions_spread_neighbouring_flows():
    """Every cell has one owner; consecutive flows of the PAPER ring land
    on all of the kernel's kBlocks blocks, none with more than twice its
    share."""
    H, G = 10, K_BLOCKS
    cells = np.arange(4096 * H, dtype=np.int64)
    counts = np.bincount(owner(cells, G), minlength=G)
    assert counts.min() > 0 and counts.max() < 2 * len(cells) / G


# -- refusals ---------------------------------------------------------------

def test_wrappers_refuse_what_the_kernels_cannot_take():
    """``ring_scatter.kernel.check_ring`` raises before any launch, on
    any device."""
    launches = RK.KERNEL.launches
    one = torch.zeros(1, 1, 16, dtype=torch.int32)
    pays = torch.zeros(4, 16, dtype=torch.int32)
    RK.check_ring(one.expand(1 << 27, 15, 16), pays)  # 2^31 - 2^27 cells
    with pytest.raises(ValueError, match="2\\^31"):
        RK.check_ring(one.expand(1 << 28, 8, 16), pays)
    with pytest.raises(ValueError, match="at most 2\\^31 - 1"):
        RK.check_ring(one, torch.zeros(1, 16, dtype=torch.int32).expand(
            1 << 31, 16))
    words = torch.zeros(4 * 16 + 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        RK.check_ring(words[4:].view(1, 4, 16), words[1:65].view(4, 16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        RK.check_ring(words[1:65].view(1, 4, 16), pays)
    assert RK.KERNEL.launches == launches


def test_k2_is_one_device_function_and_has_a_floor():
    assert RK.KERNEL.device_fns == ("ring_scatter_kernel",)
    assert RK.FLOOR.source == RK.KERNEL.source
    assert RK.FLOOR.symbol == "ring_scatter_floor"
    assert RK.ROUND.symbol == "ring_scatter_round_rows"
    assert RK.ROUND.device_fns == ()
    assert not any(n in f for n in RK.FLOOR.device_fns
                   for f in RK.KERNEL.device_fns)
