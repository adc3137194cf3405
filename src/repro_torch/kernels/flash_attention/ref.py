"""Plain PyTorch version of flash_attention: masked softmax attention over
the flattened (BH, S, D) layout, scores materialised in f32 (the port of
``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, group: int = 1, causal: bool = True,
                        scale=None):
    """q: (BH, Sq, D); k/v: (BH // group, Sk, D|Dv) -> (BH, Sq, Dv) in
    q's dtype. Scores and the p·v product accumulate in f32; p is rounded
    to v's dtype before p·v, as the TPU kernel does. The causal mask is
    top-left: query i sees keys 0..i."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    kv_idx = torch.arange(BH, device=q.device) // group
    kk, vv = k[kv_idx], v[kv_idx]                       # (BH, Sk, D|Dv)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk.float()) * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bke->bqe", p.to(v.dtype).float(),
                        vv.float()).to(q.dtype)
