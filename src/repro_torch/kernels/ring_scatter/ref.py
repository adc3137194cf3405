"""Plain PyTorch version of ring_scatter: last-write-wins placement.

``index_put_`` gives no order among duplicate indices, so each touched
(flow, hist) cell's winner — the highest masked row index, i.e. the last
write in report order — is resolved explicitly first (a scatter-amax),
and only winners write. Updates ``memory`` and ``entry_valid`` in place,
as the CUDA kernel does.
"""
from __future__ import annotations

import torch


def winner_rows(flow, hist, mask, F: int, H: int):
    """(cell index (R,) int64, bool (R,) — the row is its cell's last
    masked writer). Rows outside the ring never win."""
    R = flow.shape[0]
    flow = flow.to(torch.int64)
    hist = hist.to(torch.int64)
    ok = mask & (flow >= 0) & (flow < F) & (hist >= 0) & (hist < H)
    cell = torch.where(ok, flow * H + hist, torch.full_like(flow, F * H))
    rows = torch.arange(R, device=flow.device)
    win = torch.full((F * H + 1,), -1, dtype=torch.int64, device=flow.device)
    win.scatter_reduce_(0, cell, rows, "amax")
    return cell, ok & (win[cell] == rows)


def ring_scatter_ref(memory, entry_valid, payloads, flow, hist, mask):
    """memory (F, H, 16) u32 | entry_valid (F, H) bool | payloads (R, 16)
    | flow/hist (R,) | mask (R,) bool -> (memory, entry_valid), updated in
    place."""
    F, H, W = memory.shape
    cell, win = winner_rows(flow, hist, mask, F, H)
    cells = cell[win]
    memory.view(F * H, W)[cells] = payloads[win]
    entry_valid.view(F * H)[cells] = True
    return memory, entry_valid
