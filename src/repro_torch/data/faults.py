"""Deterministic wire-level fault injection for the DFA transport (the
port of ``repro.data.faults``).

Faults hit the translated payload batch AFTER translation (the address
and history index already ride the payload, as on the wire) and BEFORE
collector ingest — the lossy RDMA segment of §III-B:

==============  ========================================================
fault           wire meaning / what detects it
==============  ========================================================
drop            the WRITE never lands: a per-reporter seq gap
                (``lost_reports``)
bit-flip        one random bit of one random word inverted: the Fig 4
                checksum (``bad_checksum``); the discarded report is
                also a seq gap, so ``lost_reports`` counts drops + flips
duplicate       the same WRITE delivered twice, after the original:
                the §VI-B dup tracking (``seq_anomalies``)
stale replay    same (reporter, seq), scrambled stats words, VALID
                checksum: only the seq identity catches it
bounded reorder a block of ``reorder_window`` rows shuffled in place;
                the collector is order-invariant for distinct cells
==============  ========================================================

Victim classes are disjoint slices of one uniform draw per row, and drop
and flip victims are never their reporter's highest seq of the batch, so
the per-period identities are exact:

    Δbad_checksum == flips, Δseq_anomalies == dups + replays,
    Δlost_reports == drops + flips.

Duplicate / replay copies go in a second R-row region after the
originals (a copy is, by causality, later), so first-arrival-wins keeps
the original.

The injector is two functions. :func:`draw` makes every random choice
of one period — the block permutation, the per-row uniform, the flipped
word and bit, the replay scramble — from an explicit ``torch.Generator``
on the payloads' device, seeded by a fixed mix of ``(spec.seed, now,
salt)``; the schedule is a pure function of those three on a given
device type. :func:`apply` is the deterministic rest, line for line with
the reference's ``inject``. The reference draws from ``jax.random``
(threefry), which torch does not reproduce; the differential tests feed
the reference's own draws to :func:`apply` and hold it bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE

# ledger codes (metrics["fault_kind"]): one per injected-fault class
KIND_NONE = 0
KIND_DROP = 1
KIND_DUP = 2
KIND_FLIP = 3
KIND_REPLAY = 4

COUNT_KEYS = ("injected_drops", "injected_dups", "injected_flips",
              "injected_replays", "injected_reorders")
LEDGER_KEYS = ("fault_kind", "fault_flow", "fault_hist")

_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class FaultSpec:
    """A seeded, composable transport-fault schedule.

    Frozen and hashable so it can ride ``DFAConfig.fault_spec``. All-zero
    rates mean "not armed": the pipeline then skips injection entirely."""

    seed: int = 0
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    flip_rate: float = 0.0
    replay_rate: float = 0.0
    reorder_rate: float = 0.0      # per-BLOCK probability of a shuffle
    reorder_window: int = 4        # max displacement bound (block size)

    def __post_init__(self):
        for f in ("drop_rate", "dup_rate", "flip_rate", "replay_rate",
                  "reorder_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} must be a probability")
        if (self.drop_rate + self.dup_rate + self.flip_rate
                + self.replay_rate) > 1.0:
            raise ValueError(
                "drop+dup+flip+replay rates exceed 1.0 — victim classes "
                "are disjoint slices of one uniform draw, so their rates "
                "must sum to at most 1")
        if self.reorder_window < 2:
            raise ValueError("reorder_window must be >= 2")

    @property
    def armed(self) -> bool:
        return (self.drop_rate > 0 or self.dup_rate > 0
                or self.flip_rate > 0 or self.replay_rate > 0
                or self.reorder_rate > 0)

    @property
    def appends_copies(self) -> bool:
        """Whether :func:`apply` returns a 2R-row batch (copy region)."""
        return self.dup_rate > 0 or self.replay_rate > 0

    def describe(self) -> str:
        if not self.armed:
            return "none"
        parts = [f"{k}={getattr(self, k):g}" for k in
                 ("drop_rate", "dup_rate", "flip_rate", "replay_rate",
                  "reorder_rate") if getattr(self, k) > 0]
        return f"seed={self.seed}," + ",".join(parts)


class FaultDraws(NamedTuple):
    """Every random choice of one period's injection. A field is None
    when the spec has no fault that reads it."""

    perm: Optional[torch.Tensor]    # (R,) int64 — bounded reorder
    u: torch.Tensor                 # (R,) float32 — victim-class draw
    word: Optional[torch.Tensor]    # (R,) int64 in [0, W) — flipped word
    bit: Optional[torch.Tensor]     # (R,) int64 in [0, 32) — flipped bit
    scram: Optional[torch.Tensor]   # (R, n_stats) int64 in [1, 2^30)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def schedule_seed(seed: int, now: int, salt: int) -> int:
    """The generator seed of one (spec seed, period timestamp, salt)."""
    x = _splitmix64(seed & _M64)
    x = _splitmix64(x ^ (now & U.MASK))
    return _splitmix64(x ^ (salt & U.MASK)) >> 1     # manual_seed: < 2^63


def blockwise_permutation(active: torch.Tensor, rank_u: torch.Tensor,
                          window: int) -> torch.Tensor:
    """A bounded-displacement permutation of ``range(R)``: rows move only
    within their ``window``-sized block; a block whose ``active`` flag is
    set orders its rows by ``rank_u``, the others keep theirs. Two stable
    sorts: by rank, then by block."""
    R = rank_u.shape[0]
    ar = torch.arange(R, device=rank_u.device)
    blk = ar // window
    pos = (ar % window).to(torch.float32)
    rank = torch.where(active[blk], rank_u, pos)
    o1 = torch.sort(rank, stable=True).indices
    return o1[torch.sort(blk[o1], stable=True).indices]


def draw(spec: FaultSpec, R: int, wire: WIRE.WireFormat, now: int,
         salt: int, device) -> FaultDraws:
    """One period's random choices for ``R`` payload rows, from a
    ``torch.Generator`` on ``device`` seeded by :func:`schedule_seed`.
    ``now`` and ``salt`` are host integers."""
    g = torch.Generator(device=device)
    g.manual_seed(schedule_seed(int(spec.seed), int(now), int(salt)))

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    perm = None
    if spec.reorder_rate > 0:
        n_blk = (R + spec.reorder_window - 1) // spec.reorder_window
        active = rand(n_blk) < spec.reorder_rate
        perm = blockwise_permutation(active, rand(R), spec.reorder_window)
    u = rand(R)
    word = bit = scram = None
    if spec.flip_rate > 0:
        word = randint(0, wire.payload_words, R)
        bit = randint(0, 32, R)
    if spec.replay_rate > 0:
        sl = wire.payload_stats_slice
        scram = randint(1, 1 << 30, R, sl.stop - sl.start)
    return FaultDraws(perm, u, word, bit, scram)


def apply(payloads: torch.Tensor, mask: torch.Tensor, spec: FaultSpec,
          wire: WIRE.WireFormat, draws: FaultDraws
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor]]:
    """Apply ``spec`` with the given ``draws`` to one translated payload
    batch: payloads (R, 16) int32 bit patterns, mask (R,) bool.

    Returns ``(payloads', mask', counts, ledger)``; the row count is R, or
    2R when the spec injects duplicate / replay copies (the second region
    holds the copies, masked on only where one was injected). ``counts``
    holds the per-class totals (int64 scalars); ``ledger`` the per-row
    ``fault_kind`` / ``fault_flow`` / ``fault_hist`` (int64 values)."""
    R = payloads.shape[0]
    dev = payloads.device
    rows = torch.arange(R, device=dev)
    pay, m = payloads, mask
    n_moved = torch.zeros((), dtype=torch.int64, device=dev)
    if spec.reorder_rate > 0:
        perm = draws.perm
        pay, m = pay[perm], m[perm]
        n_moved = (m & (perm != rows)).sum()

    rep = wire.payload_reporter.extract(pay)
    seq = wire.payload_seq.extract(pay)
    n_rep = wire.n_reporters
    # per-reporter batch-max seq: a row holding it is the reporter's tail
    # this period; drop / flip victims exclude tails, so each gap shows
    # in the same period
    ridx = torch.where(m, rep, n_rep)
    bmax = torch.zeros(n_rep + 1, dtype=torch.int64, device=dev)
    bmax.scatter_reduce_(0, ridx, seq + 1, "amax")
    tail = m & (seq + 1 == bmax[torch.clamp(ridx, 0, n_rep)])

    # float32 compares against Python floats, as the reference's
    u = draws.u
    f0 = spec.flip_rate
    d0 = f0 + spec.drop_rate
    p0 = d0 + spec.dup_rate
    r0 = p0 + spec.replay_rate
    none = torch.zeros_like(m)
    flip = m & ~tail & (u < f0) if spec.flip_rate > 0 else none
    drop = (m & ~tail & (u >= f0) & (u < d0) if spec.drop_rate > 0
            else none)
    dup = m & (u >= d0) & (u < p0) if spec.dup_rate > 0 else none
    repl = m & (u >= p0) & (u < r0) if spec.replay_rate > 0 else none

    flow0 = U.wide(pay[:, 0])
    hist0 = wire.payload_hist.extract(pay)
    kind = torch.zeros(R, dtype=torch.int64, device=dev)

    if spec.flip_rate > 0:
        W = wire.payload_words
        bitval = torch.ones_like(draws.bit) << draws.bit
        hit = ((torch.arange(W, device=dev)[None, :] == draws.word[:, None])
               & flip[:, None])
        pay = U.narrow(U.wide(pay) ^ torch.where(hit, bitval[:, None], 0))
        kind = torch.where(flip, KIND_FLIP, kind)
    if spec.drop_rate > 0:
        m = m & ~drop
        kind = torch.where(drop, KIND_DROP, kind)

    counts = {
        "injected_drops": drop.sum(),
        "injected_dups": dup.sum(),
        "injected_flips": flip.sum(),
        "injected_replays": repl.sum(),
        "injected_reorders": n_moved,
    }

    if not spec.appends_copies:
        return pay, m, counts, {"fault_kind": kind, "fault_flow": flow0,
                                "fault_hist": hist0}

    # copy region: duplicates are byte-identical; replays keep the
    # (reporter, seq, flow, hist) identity but scramble the stats words
    # and re-fold a VALID checksum — only the seq defence can catch them
    cp = pay
    cmask = dup | repl
    ckind = torch.where(dup, KIND_DUP,
                        torch.where(repl, KIND_REPLAY, KIND_NONE))
    if spec.replay_rate > 0:
        sl = wire.payload_stats_slice
        cw = U.wide(cp)
        stats = torch.where(repl[:, None], cw[:, sl] ^ draws.scram,
                            cw[:, sl])
        cw = torch.cat([cw[:, :sl.start], stats, cw[:, sl.stop:]], dim=1)
        pos = PROTO.covered_positions(wire, dev)
        csum = PROTO.xor_checksum(cw[:, pos], pos)
        cw[:, wire.csum_word] = torch.where(repl, csum,
                                            cw[:, wire.csum_word])
        cp = U.narrow(cw)

    ledger = {
        "fault_kind": torch.cat([kind, ckind]),
        "fault_flow": torch.cat([flow0, U.wide(cp[:, 0])]),
        "fault_hist": torch.cat([hist0, wire.payload_hist.extract(cp)]),
    }
    return (torch.cat([pay, cp]), torch.cat([m, cmask]), counts, ledger)


def host_int(v) -> int:
    """A period timestamp or salt as a host integer (a device tensor is
    read back, which waits for the device)."""
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def inject(payloads: torch.Tensor, mask: torch.Tensor, spec: FaultSpec,
           wire: WIRE.WireFormat, now, salt):
    """``apply`` with this period's :func:`draw` (``now`` and ``salt``:
    host ints or 0-d tensors)."""
    draws = draw(spec, payloads.shape[0], wire, host_int(now),
                 host_int(salt), payloads.device)
    return apply(payloads, mask, spec, wire, draws)
