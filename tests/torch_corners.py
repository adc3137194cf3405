"""Corner inputs of the feature derivation (gather_enrich, derived_features).

Imports numpy only, so that both the CPU tests (against JAX) and the
card's tests (``tests/test_torch_cuda.py``, run without JAX) build the
same inputs from the same numpy seed.

Rows cycle through the kinds the newest-entry selection has to get
right (``jnp.argmax`` on ``where(valid, count, 0)`` as uint32: the first
index of the largest count; invalid entries count 0, so entry 0 wins
when no valid count is above 0, even if it is invalid):

0. plausible flows (the moment sums of ``packets.synthetic_ring``);
1. every entry on one count: a tie, won by the first valid entry
   (entry 0 invalid in every other such row);
2. every valid count 0 and entry 0 invalid: entry 0 wins, and the
   newest features are 0;
3. counts at and above 2^31 beside small ones: the comparison is
   unsigned;
4. no valid entry;
5. counts from {7, 9}: ties at the maximum among many entries.

hist_idx sits in V1's word 13 or V2's word 15 (low 8 bits), with random
bits above it and in the other format's word, so a wrong word or mask
shows.
"""
import numpy as np

KINDS = 6
U32_MAX = (1 << 32) - 1


def corner_ring(rng, rows: int, history: int, wire: str = "v1"):
    """(rows, history, 16) uint32 + (rows, history) bool, as numpy."""
    shape = (rows, history)
    n = rng.integers(1, 2001, shape).astype(np.float64)
    kind = np.arange(rows) % KINDS
    valid = rng.random(shape) < 0.7
    k = kind[:, None]
    tie = np.broadcast_to(rng.integers(1, 2001, (rows, 1)), shape)
    n = np.where(k == 1, tie, n)
    n = np.where(k == 2, 0.0, n)
    big = (1 << 31) + rng.integers(0, 1 << 31, shape)
    n = np.where((k == 3) & (rng.random(shape) < 0.4), big, n)
    n = np.where(k == 5, rng.choice([7.0, 9.0], shape), n)
    valid = np.where(k == 4, False, valid)
    valid[kind == 2, 0] = False
    valid[(kind == 1) & (np.arange(rows) % 12 == 1), 0] = False
    cols = [n]
    for lo, hi in ((1, 2001), (40, 1501)):
        m = rng.integers(lo, hi, shape).astype(np.float64)
        for p in (1, 2, 3):
            scale = 1.0 + (rng.random(shape) if p > 1 else 0.0)
            cols.append(n * m ** p * scale)
    mem = rng.integers(0, 1 << 32, shape + (16,), dtype=np.uint64)
    mem[..., 1:8] = np.minimum(np.stack(cols, -1), U32_MAX).astype(np.uint64)
    hist = rng.integers(0, 256, shape).astype(np.uint64)
    word = 13 if wire == "v1" else 15
    mem[..., word] = (mem[..., word] & ~np.uint64(0xFF)) | hist
    return mem.astype(np.uint32), valid


def corner_ids(rng, rows: int, flows: int):
    """(rows,) int64 flow ids: in range, below 0, at and above ``flows``
    (clamped by the kernel), and runs of duplicates."""
    ids = rng.integers(0, flows, rows)
    pick = rng.random(rows)
    ids = np.where(pick < 0.1, -rng.integers(1, 5, rows), ids)
    ids = np.where((pick >= 0.1) & (pick < 0.2),
                   flows + rng.integers(0, 5, rows), ids)
    ids = np.where((pick >= 0.2) & (pick < 0.35), ids[0], ids)
    return ids.astype(np.int64)
