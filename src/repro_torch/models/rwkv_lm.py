"""rwkv6-3b full-model assembly, attention-free (the port of
``repro.models.rwkv_lm``).

The parameters keep the reference's layout: the blocks' leaves stacked
(L, ...), walked with a Python loop after one ``lm.unstack``. Under
``cfg.remat == "full"`` and autograd each block is recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of the scan body). The decode cache is the reference's: one dict of
per-layer states stacked (L, B, ...) (:func:`rwkv_cache_descs`), whose
size does not grow with the sequence; decode updates it in place. No
module of this family calls attention, so it launches no kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models.lm import loss_mask, unstack

Tree = Any


def rwkv_lm_descs(cfg: ModelConfig) -> Tree:
    return {
        "embed": L.embed_descs(cfg),
        "ln0": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
        "blocks": L.stack_descs(R.rwkv6_descs(cfg), cfg.num_layers),
        "final_norm": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
    }


def _embed(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """The token embedding, layer-normed (``ln0``)."""
    return L.layer_norm(params["ln0"], L.embed(params["embed"], tokens),
                        cfg.norm_eps)


def rwkv_hidden(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Full forward to the final hidden states (B, S, d)."""
    x = _embed(params, batch["tokens"], cfg)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in unstack(params["blocks"], cfg.num_layers):
        x = (checkpoint(R.rwkv6_block_train, lp, x, cfg, use_reentrant=False)
             if remat else R.rwkv6_block_train(lp, x, cfg))
    return L.layer_norm(params["final_norm"], x, cfg.norm_eps)


def rwkv_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}
    and an optional "mask", all (B, S)), f32 0-d."""
    x = rwkv_hidden(params, batch, cfg)
    return L.chunked_ce_loss(params["embed"], x, batch["targets"],
                             loss_mask(batch), cfg.tie_embeddings,
                             cfg.loss_chunk)


def rwkv_cache_descs(cfg: ModelConfig, batch: int, seq: int) -> Tree:
    """The recurrent state of every layer, stacked (L, batch, ...), f32;
    ``seq`` does not change it."""
    return L.stack_descs(R.rwkv6_state_descs(cfg, batch), cfg.num_layers)


def rwkv_prefill(params, batch, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward that also collects each layer's state after
    the prompt. Returns (last-token logits (B, V), the cache of
    :func:`rwkv_cache_descs`)."""
    x = _embed(params, batch["tokens"], cfg)
    states = []
    for lp in unstack(params["blocks"], cfg.num_layers):
        x, st = R.rwkv6_block_train(lp, x, cfg, return_state=True)
        states.append(st)
    x = L.layer_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x[:, -1:, :],
                         cfg.tie_embeddings)[:, 0]
    return logits, {n: torch.stack([st[n] for st in states])
                    for n in states[0]}


def rwkv_decode(params, token, pos, cache, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token: (B,1) int; ``pos`` is not read (the state carries the
    position); cache from :func:`rwkv_cache_descs`, whose tensors are
    updated in place. Returns (logits (B, V), cache')."""
    x = _embed(params, token, cfg)
    for i, lp in enumerate(unstack(params["blocks"], cfg.num_layers)):
        x, new = R.rwkv6_block_decode(lp, x, cfg,
                                      {n: t[i] for n, t in cache.items()})
        for n, t in new.items():
            cache[n][i].copy_(t)
    x = L.layer_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, cache
