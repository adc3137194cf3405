"""Plain PyTorch versions for the ingest_update family.

``ingest_update_ref`` is the multipass oracle (admit, stable-sort IAT
resolution, a materialized (E, 7) delta array, a per-event
scatter-accumulate). ``segment_sums_ref`` is the plain version of the
CUDA kernel ``ingest_segment_sums``: the same (Ep, 8) per-tile run-prefix
sums, computed as per-tile cumulative sums in int64 minus the exclusive
sum at each run head. All math is integer mod 2^32, so every
implementation must agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import u32 as U
from repro_torch.core.reporter import (accumulate_ref, admit_arrays,
                                       event_deltas, resolve_iat)
from repro_torch.kernels.ingest_update.kernel import REG_PAD, delta_cols


def ingest_update_ref(regs, last_ts, keys, active, collisions, slots, ts,
                      ps, five_tuple, valid, *, logstar_bits: int):
    """-> (regs, last_ts, keys, active, collisions), the multipass way."""
    pre_active = active                  # admissions see themselves as new
    keys, active, collisions = admit_arrays(keys, active, collisions, slots,
                                            five_tuple, valid)
    iat, first, last_ts = resolve_iat(slots, ts, valid, last_ts, pre_active)
    deltas = event_deltas(iat, ps, first, valid, logstar_bits)
    regs = accumulate_ref(regs, slots, deltas, valid)
    return regs, last_ts, keys, active, collisions


def segment_sums_ref(s_slot, s_ts, s_ps, base_ts, first_i32, log_lut,
                     exp_lut, *, bits: int, tile: int) -> torch.Tensor:
    """(Ep,) sorted stream -> (Ep, 8) int32 bit patterns: row r holds the
    sum mod 2^32 of its run's deltas from the run's first row inside r's
    tile through r (column 7 is zero)."""
    Ep = s_slot.shape[0]
    n_tiles = Ep // tile
    iat = torch.where(first_i32 != 0, 0,
                      (U.wide(s_ts) - U.wide(base_ts)) & U.MASK)
    d = torch.stack(delta_cols(iat, U.wide(s_ps), bits, log_lut, exp_lut)
                    + (torch.zeros_like(iat),), dim=-1)
    d = d.reshape(n_tiles, tile, REG_PAD)
    slot = s_slot.reshape(n_tiles, tile)
    pos = torch.arange(tile, device=s_slot.device).expand(n_tiles, tile)
    head = torch.ones_like(slot, dtype=torch.bool)
    head[:, 1:] = slot[:, 1:] != slot[:, :-1]
    head_pos = torch.cummax(torch.where(head, pos, 0), dim=1).values
    cs = torch.cumsum(d, dim=1)                 # exact in int64 (<2^40)
    excl = cs - d
    sums = cs - torch.gather(excl, 1,
                             head_pos[..., None].expand(-1, -1, REG_PAD))
    return U.narrow(sums.reshape(Ep, REG_PAD))
