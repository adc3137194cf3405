"""Decoder-only LM assembly, dense family (the port of
``repro.models.lm``).

The parameters keep the reference's layout: one stacked ``(L, ...)`` tree
under ``stack_0_dense`` that the reference scans over and the port walks
with a Python loop. The decode cache is the reference's list of per-layer
``{"k", "v"}`` dicts. :func:`lm_loss` is the training loss; under
``cfg.remat == "full"`` each block is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
scan body). The moe / vlm families and multi-token prediction are
ROADMAP §1 item 14c.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.param import ParamDesc

Tree = Any
STACK = "stack_0_dense"


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP §1 item "
            "14); the port runs the dense family")


def block_descs(cfg: ModelConfig) -> Tree:
    """One dense transformer block."""
    return {"ln1": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            "ln2": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            "attn": A.attn_descs(cfg),
            "ffn": L.ffn_descs(cfg)}


def lm_descs(cfg: ModelConfig) -> Tree:
    check_dense(cfg)
    return {"embed": L.embed_descs(cfg),
            "final_norm": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            STACK: L.stack_descs(block_descs(cfg), cfg.num_layers)}


def unstack(stack: Tree, n: int) -> List[Tree]:
    """Every layer's slice of a stacked tree (views), each leaf cut once
    with ``unbind``: under autograd that is one node per leaf, whose
    backward stacks the n slices' gradients once (``stack[layer]`` per
    layer would build a zero-filled (L, ...) gradient per layer)."""
    if isinstance(stack, dict):
        parts = {k: unstack(v, n) for k, v in stack.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(stack.unbind(0))


# ------------------------------------------------------------- blocks ------

def block_train(params, x, cfg: ModelConfig,
                backend: Optional[str] = None):
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    x = x + A.attn_train(params["attn"], h, cfg, backend=backend)
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + L.ffn(params["ffn"], h, cfg.act)


def block_prefill(params, x, cfg: ModelConfig,
                  backend: Optional[str] = None):
    """Like train but returns the KV-cache contribution."""
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    h, kv = A.attn_train(params["attn"], h, cfg, return_kv=True,
                         backend=backend)
    x = x + h
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + L.ffn(params["ffn"], h, cfg.act), kv


def block_decode(params, x, cfg: ModelConfig, cache, pos):
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    h, k, v = A.attn_decode(params["attn"], h, cfg, cache["k"], cache["v"],
                            pos)
    x = x + h
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + L.ffn(params["ffn"], h, cfg.act), {"k": k, "v": v}


# ------------------------------------------------------------ assembly -----

def lm_hidden(params, batch, cfg: ModelConfig,
              backend: Optional[str] = None) -> torch.Tensor:
    """Full forward to the final hidden states (B, S, d). Under
    ``cfg.remat == "full"`` and autograd, each block keeps only its input
    and runs again in the backward."""
    x = L.embed(params["embed"], batch["tokens"])
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in unstack(params[STACK], cfg.num_layers):
        if remat:
            x = checkpoint(block_train, lp, x, cfg, backend,
                           use_reentrant=False)
        else:
            x = block_train(lp, x, cfg, backend=backend)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig,
            backend: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}
    and an optional "mask", all (B, S)), f32 0-d."""
    if cfg.mtp_depth:
        raise NotImplementedError(
            "multi-token prediction (mtp_depth, deepseek) is not ported yet "
            "(ROADMAP §1 item 14c)")
    x = lm_hidden(params, batch, cfg, backend=backend)
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return L.chunked_ce_loss(params["embed"], x, targets, mask,
                             cfg.tie_embeddings, cfg.loss_chunk)


def cache_descs(cfg: ModelConfig, batch: int, seq: int) -> List[Tree]:
    """The decode cache: a list of per-layer ``{"k", "v"}`` of shape
    (batch, seq, KH, D) in the activation dtype."""
    check_dense(cfg)
    D = cfg.resolved_head_dim
    shape = (batch, seq, cfg.num_kv_heads, D)
    return [{"k": ParamDesc(shape, cfg.dtype, init="zeros"),
             "v": ParamDesc(shape, cfg.dtype, init="zeros")}
            for _ in range(cfg.num_layers)]


def lm_prefill(params, batch, cfg: ModelConfig,
               backend: Optional[str] = None
               ) -> Tuple[torch.Tensor, List[Tree]]:
    """Returns (last-token logits (B, V), per-layer cache of the prompt:
    a list of ``{"k", "v"}`` of shape (B, S, KH, D))."""
    x = L.embed(params["embed"], batch["tokens"])
    cache = []
    for lp in unstack(params[STACK], cfg.num_layers):
        x, (k, v) = block_prefill(lp, x, cfg, backend=backend)
        cache.append({"k": k, "v": v})
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x[:, -1:, :],
                         cfg.tie_embeddings)[:, 0]
    return logits, cache


def lm_decode(params, token, pos, cache, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, List[Tree]]:
    """token: (B,1) int; pos: (B,) int; cache from :func:`cache_descs`,
    whose tensors are updated in place. Returns (logits (B, V), cache')."""
    x = L.embed(params["embed"], token)
    new_cache = list(cache)
    for layer, lp in enumerate(unstack(params[STACK], cfg.num_layers)):
        x, new = block_decode(lp, x, cfg, cache[layer], pos)
        new_cache[layer] = {n: t.to(cache[layer][n].dtype)
                            for n, t in new.items()}
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, new_cache
