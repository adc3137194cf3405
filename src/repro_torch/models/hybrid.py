"""zamba2 hybrid assembly: a Mamba2 trunk with shared full-attention
blocks (the port of ``repro.models.hybrid``).

Layers are grouped into segments of ``attn_every`` Mamba2 blocks followed
by one shared attention + FFN block; the ``num_shared_blocks`` (2) weight
sets alternate across segments, block ``seg % 2`` serving segment ``seg``
(zamba2's per-invocation LoRA adapters are omitted, as in the reference).
The parameters keep the reference's layout: the trunk's leaves stacked
(nseg, per, ...) and the shared blocks' (2, ...); the reference scans over
them and the port walks them with Python loops, cut once with
``lm.unstack``. The shared attention goes through
``attention.attn_train``, so on the card it launches K6 and, in the
backward, K7. Under ``cfg.remat == "full"`` and autograd each Mamba2 layer
and each shared block is recomputed in the backward
(``torch.utils.checkpoint``; the reference checkpoints each Mamba2 layer
and each segment). The decode cache is the reference's list of nseg
dicts ``{"mamba": the segment's per-layer states stacked (per, ...),
"attn_k", "attn_v"}``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.lm import loss_mask, unstack
from repro_torch.models.param import ParamDesc

Tree = Any


def _plan(cfg: ModelConfig) -> Tuple[int, int]:
    """(number of segments, Mamba2 layers per segment)."""
    k = cfg.hybrid.attn_every
    if cfg.num_layers % k:
        raise ValueError(f"hybrid: num_layers {cfg.num_layers} is not a "
                         f"multiple of attn_every {k}")
    return cfg.num_layers // k, k


def hybrid_descs(cfg: ModelConfig) -> Tree:
    nseg, per = _plan(cfg)
    mamba = L.stack_descs(L.stack_descs(
        {"ln": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
         "mamba": S.mamba2_descs(cfg)}, per), nseg)
    shared = L.stack_descs(
        {"ln1": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
         "attn": A.attn_descs(cfg),
         "ln2": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
         "ffn": L.ffn_descs(cfg)}, cfg.hybrid.num_shared_blocks)
    return {"embed": L.embed_descs(cfg),
            "final_norm": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            "trunk": mamba, "shared": shared}


def _walk(params, cfg: ModelConfig):
    """(per segment, its Mamba2 layers' parameters; the shared blocks'
    parameters), the stacks cut once."""
    nseg, per = _plan(cfg)
    trunk = [unstack(seg, per) for seg in unstack(params["trunk"], nseg)]
    return trunk, unstack(params["shared"], cfg.hybrid.num_shared_blocks)


def _select_shared(shared: List[Tree], seg_idx: int) -> Tree:
    """The shared block that serves segment ``seg_idx``."""
    return shared[seg_idx % len(shared)]


def _mamba_layer(lp, x, cfg: ModelConfig, return_state: bool = False):
    """One pre-norm residual Mamba2 layer; ``return_state``: also its
    decode state (``ssm.mamba2_train``)."""
    y = S.mamba2_train(lp["mamba"], L.rms_norm(lp["ln"], x, cfg.norm_eps),
                       cfg, return_state=return_state)
    if return_state:
        return x + y[0], y[1]
    return x + y


def _shared_attn_train(sp, x, cfg: ModelConfig,
                       backend: Optional[str] = None,
                       return_kv: bool = False):
    """One shared attention + FFN block; ``return_kv``: also its
    attention's (k, v)."""
    h = L.rms_norm(sp["ln1"], x, cfg.norm_eps)
    out = A.attn_train(sp["attn"], h, cfg, return_kv=return_kv,
                       backend=backend)
    a, kv = out if return_kv else (out, None)
    x = x + a
    h = L.rms_norm(sp["ln2"], x, cfg.norm_eps)
    x = x + L.ffn(sp["ffn"], h, cfg.act)
    return (x, kv) if return_kv else x


def hybrid_hidden(params, batch, cfg: ModelConfig,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Full forward to the final hidden states (B, S, d)."""
    x = L.embed(params["embed"], batch["tokens"])
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    trunk, shared = _walk(params, cfg)
    for seg, layers in enumerate(trunk):
        for lp in layers:
            x = (checkpoint(_mamba_layer, lp, x, cfg, use_reentrant=False)
                 if remat else _mamba_layer(lp, x, cfg))
        sp = _select_shared(shared, seg)
        x = (checkpoint(_shared_attn_train, sp, x, cfg, backend,
                        use_reentrant=False)
             if remat else _shared_attn_train(sp, x, cfg, backend))
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def hybrid_loss(params, batch, cfg: ModelConfig,
                backend: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}
    and an optional "mask", all (B, S)), f32 0-d."""
    x = hybrid_hidden(params, batch, cfg, backend=backend)
    return L.chunked_ce_loss(params["embed"], x, batch["targets"],
                             loss_mask(batch), cfg.tie_embeddings,
                             cfg.loss_chunk)


# -------------------------------------------------------------- caches -----

def hybrid_cache_descs(cfg: ModelConfig, batch: int, seq: int) -> List[Tree]:
    """A list of per-segment caches: the segment's Mamba2 states (f32,
    stacked (per, ...)) and its shared block's K/V (batch, seq, KH, D) in
    the activation dtype."""
    nseg, per = _plan(cfg)
    kv = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"mamba": L.stack_descs(S.mamba2_state_descs(cfg, batch), per),
             "attn_k": ParamDesc(kv, cfg.dtype, init="zeros"),
             "attn_v": ParamDesc(kv, cfg.dtype, init="zeros")}
            for _ in range(nseg)]


def hybrid_prefill(params, batch, cfg: ModelConfig,
                   backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, List[Tree]]:
    """The training forward that also collects each Mamba2 layer's final
    states and each segment's attention K/V. Returns (last-token logits
    (B, V), the cache of :func:`hybrid_cache_descs` over the prompt's
    length)."""
    x = L.embed(params["embed"], batch["tokens"])
    trunk, shared = _walk(params, cfg)
    cache = []
    for seg, layers in enumerate(trunk):
        states = []
        for lp in layers:
            x, st = _mamba_layer(lp, x, cfg, return_state=True)
            states.append(st)
        x, (k, v) = _shared_attn_train(_select_shared(shared, seg), x, cfg,
                                       backend, return_kv=True)
        cache.append({"mamba": {n: torch.stack([st[n] for st in states])
                                for n in states[0]},
                      "attn_k": k, "attn_v": v})
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x[:, -1:, :],
                         cfg.tie_embeddings)[:, 0]
    return logits, cache


def hybrid_decode(params, token, pos, cache, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, List[Tree]]:
    """token: (B,1) int; pos: (B,) int; cache from
    :func:`hybrid_cache_descs`, whose tensors are updated in place.
    Returns (logits (B, V), cache')."""
    x = L.embed(params["embed"], token)
    trunk, shared = _walk(params, cfg)
    for seg, layers in enumerate(trunk):
        states = cache[seg]["mamba"]
        for i, lp in enumerate(layers):
            y, new = S.mamba2_decode(
                lp["mamba"], L.rms_norm(lp["ln"], x, cfg.norm_eps), cfg,
                {n: t[i] for n, t in states.items()})
            x = x + y
            for n, t in new.items():
                states[n][i].copy_(t)
        sp = _select_shared(shared, seg)
        h = L.rms_norm(sp["ln1"], x, cfg.norm_eps)
        a, _, _ = A.attn_decode(sp["attn"], h, cfg, cache[seg]["attn_k"],
                                cache[seg]["attn_v"], pos)
        x = x + a
        h = L.rms_norm(sp["ln2"], x, cfg.norm_eps)
        x = x + L.ffn(sp["ffn"], h, cfg.act)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, cache
