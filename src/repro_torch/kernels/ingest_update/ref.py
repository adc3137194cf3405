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
from repro_torch.core import reporter as REP
from repro_torch.kernels.ingest_update.kernel import REG_PAD, delta_cols


def ingest_update_ref(regs, last_ts, keys, active, collisions, slots, ts,
                      ps, five_tuple, valid, cfg):
    """-> (regs, last_ts, keys, active, collisions): the reporter's
    multipass ingest with the scatter-accumulate oracle."""
    st = REP.ReporterState(regs, last_ts, None, keys, active, None,
                           collisions)      # report fields are not touched
    st = REP._ingest_multipass(st, slots, {"ts": ts, "size": ps,
                                           "five_tuple": five_tuple,
                                           "valid": valid}, cfg,
                               REP.accumulate_ref)
    return st.regs, st.last_ts, st.keys, st.active, st.collisions


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
