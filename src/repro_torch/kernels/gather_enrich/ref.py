"""Plain PyTorch version of gather_enrich: explicit history gather, then
the enrichment oracle — materializes the (R, H, 16) intermediate the
CUDA kernel avoids."""
from __future__ import annotations

import torch

from repro_torch.core.enrich import derive_ref


def gather_enrich_ref(memory, entry_valid, local_flow, cfg) -> torch.Tensor:
    """memory (F, H, 16) u32 | entry_valid (F, H) bool | local_flow (R,)
    (clamped to [0, F)) -> (R, derived_dim) f32."""
    lf = torch.clamp(local_flow.to(torch.int64), 0, memory.shape[0] - 1)
    return derive_ref(memory[lf], entry_valid[lf], cfg)
