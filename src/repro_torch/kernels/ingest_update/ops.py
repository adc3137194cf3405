"""Wrappers for the ingest_update family (reporter stage 1).

``segment_sums`` launches the CUDA kernel for CUDA tensors and runs its
plain version (``ref.segment_sums_ref``) for CPU tensors or under
``backend="ref"`` (see ``kernels.dispatch``). ``ingest_update`` picks the
multipass oracle for ``backend="ref"`` and the fused sort-once path
otherwise; both are bitwise equal.
"""
from __future__ import annotations

import torch

from repro_torch.core import logstar as LS
from repro_torch.kernels import dispatch
from repro_torch.kernels.ingest_update import kernel as K
from repro_torch.kernels.ingest_update import ref as REF


def segment_sums(s_slot, s_ts, s_ps, base_ts, first_i32, *, bits: int,
                 tile: int, backend=None) -> torch.Tensor:
    """(Ep,) sorted stream -> (Ep, 8) per-tile run-prefix sums (int32 bit
    patterns). Contract: ``ref.segment_sums_ref``."""
    if dispatch.use_kernel(s_slot, backend):
        luts = LS.lut_tensors(bits, s_slot.device, torch.int32)
        return K.segment_sums_cuda(s_slot, s_ts, s_ps, base_ts, first_i32,
                                   *luts, bits=bits, tile=tile)
    luts = LS.lut_tensors(bits, s_slot.device)
    return REF.segment_sums_ref(s_slot, s_ts, s_ps, base_ts, first_i32,
                                *luts, bits=bits, tile=tile)


def ingest_update_fused(regs, last_ts, keys, active, collisions, slots, ts,
                        ps, five_tuple, valid, cfg, backend=None):
    """Sort once, reduce per run segment (the kernel), apply one
    scatter-add per segment."""
    if slots.shape[0] == 0:
        return regs, last_ts, keys, active, collisions
    st = K.stream_prep(last_ts, keys, active, slots, ts, ps, five_tuple,
                       valid, cfg.event_tile)
    sums = segment_sums(st.s_slot, st.s_ts, st.s_ps, st.base_ts,
                        st.first.to(torch.int32), bits=cfg.logstar_bits,
                        tile=st.tile, backend=backend)
    # a run's sum is cut at every tile boundary it crosses; the
    # scatter-add re-merges the partials
    idx = torch.arange(st.s_slot.shape[0], device=slots.device)
    tile_cut = (idx % st.tile) == (st.tile - 1)
    return K.apply_updates(regs, last_ts, keys, active, collisions, st,
                           sums, st.run_tail | tile_cut)


def ingest_update(regs, last_ts, keys, active, collisions, slots, ts, ps,
                  five_tuple, valid, cfg, backend=None):
    """(F, ·) reporter registers + one (E,) event block -> the five
    updated register arrays. ``backend="ref"`` runs the multipass oracle,
    anything else the fused path."""
    b = dispatch.check_backend(backend or cfg.kernel_backend)
    if slots.shape[0] == 0:
        return regs, last_ts, keys, active, collisions
    if b == "ref":
        return REF.ingest_update_ref(regs, last_ts, keys, active,
                                     collisions, slots, ts, ps, five_tuple,
                                     valid, cfg)
    return ingest_update_fused(regs, last_ts, keys, active, collisions,
                               slots, ts, ps, five_tuple, valid, cfg,
                               backend=b)
