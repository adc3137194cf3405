"""Decoder-only LM assembly, the dense, vlm and moe families (the port
of ``repro.models.lm``).

The parameters keep the reference's layout: per contiguous run of one
block kind (:func:`_segments`) a stacked ``(L, ...)`` tree under
``stack_{i}_{kind}`` that the reference scans over and the port walks
with a Python loop (the dense family has one, ``stack_0_dense``;
deepseek-v3 has ``stack_0_dense`` for its first 3 layers and
``stack_1_moe`` for the rest). A block attends with MLA when
``cfg.mla`` is set, else with GQA, and runs the MoE FFN or a dense one.
The multi-token-prediction block (``mtp``) is in the tree when
``cfg.mtp_depth`` is set, so the reference's parameters cross whole;
serving never reads it. The decode cache is the reference's list of
per-layer ``{"k", "v"}`` dicts, or ``{"ckv", "kr"}`` (the latent cache)
under MLA. :func:`lm_loss` is the training loss of both families, with
the multi-token-prediction loss (:func:`_mtp_loss`) added at weight 0.3
when the tree holds ``mtp``; under ``cfg.remat == "full"`` each block of
the stacks is recomputed in the backward (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` of the scan body), the MTP block is
not. The vlm family is the dense one with a prefix: ``batch["patches"]``
(B, n_prefix, d_model), precomputed patch embeddings, go before the
token embeddings (:func:`_embed_input`), so the forward and the prefill
run over n_prefix + S positions and RoPE numbers them from 0; the loss
drops the prefix's rows, and a decode step's ``pos`` counts them.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.param import ParamDesc

Tree = Any
FAMILIES = ("dense", "vlm", "moe")


def check_family(cfg: ModelConfig) -> None:
    """This module's guard: the decoder-only LM families. The hybrid, ssm
    and encdec families run through ``models.hybrid``, ``models.rwkv_lm``
    and ``models.whisper`` (``Model`` dispatches)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"models.lm runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} (the hybrid, ssm and encdec families run "
            f"through Model)")


def block_descs(cfg: ModelConfig, kind: str) -> Tree:
    """One transformer block. kind: "dense" | "moe"."""
    t = {"ln1": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
         "ln2": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
         "attn": A.mla_descs(cfg) if cfg.mla else A.attn_descs(cfg)}
    if kind == "moe":
        t["moe"] = M.moe_descs(cfg)
    else:
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        t["ffn"] = L.ffn_descs(cfg, d_ff)
    return t


def _segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(kind, n_layers)]: the contiguous runs of one block kind."""
    if cfg.family == "moe":
        nd = cfg.moe.first_moe_layer
        return ([("dense", nd)] if nd else []) + [("moe",
                                                    cfg.num_layers - nd)]
    return [("dense", cfg.num_layers)]


def layers(params, cfg: ModelConfig) -> List[Tuple[str, Tree]]:
    """Every layer's (kind, parameters) in order, cut once from the
    stacks with :func:`unstack`."""
    out = []
    for i, (kind, n) in enumerate(_segments(cfg)):
        out += [(kind, lp) for lp in unstack(params[f"stack_{i}_{kind}"], n)]
    return out


def lm_descs(cfg: ModelConfig) -> Tree:
    check_family(cfg)
    t = {"embed": L.embed_descs(cfg),
         "final_norm": L.rms_norm_descs(cfg.d_model, cfg.param_dtype)}
    for i, (kind, n) in enumerate(_segments(cfg)):
        t[f"stack_{i}_{kind}"] = L.stack_descs(block_descs(cfg, kind), n)
    if cfg.mtp_depth:
        t["mtp"] = {
            "proj": L.linear_descs(2 * cfg.d_model, cfg.d_model,
                                   cfg.param_dtype, in_axis="embed"),
            "norm_h": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            "norm_e": L.rms_norm_descs(cfg.d_model, cfg.param_dtype),
            "block": block_descs(cfg, "moe" if cfg.moe else "dense"),
        }
    return t


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

def _attend(params, h, cfg: ModelConfig, return_kv: bool,
            backend: Optional[str], q_offset: int = 0):
    fn = A.mla_train if cfg.mla else A.attn_train
    return fn(params["attn"], h, cfg, q_offset=q_offset, return_kv=return_kv,
              backend=backend)


def _ffn(params, h, cfg: ModelConfig, kind: str):
    if kind == "moe":
        return M.moe_ffn(params["moe"], h, cfg)
    return L.ffn(params["ffn"], h, cfg.act)


def block_train(params, x, cfg: ModelConfig, backend: Optional[str] = None,
                kind: str = "dense", q_offset: int = 0):
    """One block over positions q_offset..q_offset+S-1 of x: (B,S,d)
    (attention's rope positions and causal mask, as the reference's)."""
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    x = x + _attend(params, h, cfg, False, backend, q_offset)
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + _ffn(params, h, cfg, kind)


def block_prefill(params, x, cfg: ModelConfig,
                  backend: Optional[str] = None, kind: str = "dense"):
    """Like train but returns the cache contribution: (k, v), or (c_kv,
    k_rope) under MLA."""
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    h, kv = _attend(params, h, cfg, True, backend)
    x = x + h
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + _ffn(params, h, cfg, kind), kv


def block_decode(params, x, cfg: ModelConfig, cache, pos,
                 kind: str = "dense"):
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        h, ckv, kr = A.mla_decode(params["attn"], h, cfg, cache["ckv"],
                                  cache["kr"], pos)
        new_cache = {"ckv": ckv, "kr": kr}
    else:
        h, k, v = A.attn_decode(params["attn"], h, cfg, cache["k"],
                                cache["v"], pos)
        new_cache = {"k": k, "v": v}
    x = x + h
    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + _ffn(params, h, cfg, kind), new_cache


# ------------------------------------------------------------ assembly -----

def _embed_input(params, batch, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, int]:
    """The token embeddings, after the patch prefix when the batch has
    ``"patches"`` (cast to the embeddings' dtype): (x (B, n_prefix + S,
    d), n_prefix)."""
    x = L.embed(params["embed"], batch["tokens"])
    patches = batch.get("patches")
    if patches is None:
        return x, 0
    return torch.cat([patches.to(x.dtype), x], 1), patches.shape[1]


def lm_hidden(params, batch, cfg: ModelConfig,
              backend: Optional[str] = None) -> torch.Tensor:
    """Full forward to the final hidden states (B, n_prefix + S, d), the
    patch prefix's rows first. Under ``cfg.remat == "full"`` and
    autograd, each block keeps only its input and runs again in the
    backward."""
    x, _ = _embed_input(params, batch, cfg)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for kind, lp in layers(params, cfg):
        if remat:
            x = checkpoint(block_train, lp, x, cfg, backend, kind,
                           use_reentrant=False)
        else:
            x = block_train(lp, x, cfg, backend=backend, kind=kind)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig,
            backend: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}
    and an optional "mask", all (B, S); for the vlm family "patches"),
    over the text's positions, f32 0-d; plus 0.3 x :func:`_mtp_loss` when
    ``cfg.mtp_depth`` is set and the tree holds the MTP block."""
    check_family(cfg)
    x = lm_hidden(params, batch, cfg, backend=backend)
    x = x[:, x.shape[1] - batch["tokens"].shape[1]:]     # drop the prefix
    mask = loss_mask(batch)
    loss = L.chunked_ce_loss(params["embed"], x, batch["targets"], mask,
                             cfg.tie_embeddings, cfg.loss_chunk)
    if cfg.mtp_depth and "mtp" in params:
        loss = loss + 0.3 * _mtp_loss(params, x, batch, mask, cfg, backend)
    return loss


def loss_mask(batch) -> torch.Tensor:
    """The batch's "mask", or f32 ones over its targets."""
    mask = batch.get("mask")
    if mask is None:
        targets = batch["targets"]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return mask


def _mtp_loss(params, h, batch, mask, cfg: ModelConfig,
              backend: Optional[str]) -> torch.Tensor:
    """Single-depth multi-token prediction (deepseek-v3 §2.2): the normed
    main hidden state at position t and the embedding of token t + 1,
    each normed, are projected to d_model and run through one block (its
    kind that of the tree's block) to predict token t + 2 with the shared
    embedding and head; the last position, whose rolled target wraps,
    is masked."""
    p = params["mtp"]
    tokens, targets = batch["tokens"], batch["targets"]
    S = tokens.shape[1]
    emb_next = L.embed(params["embed"], torch.roll(tokens, -1, dims=1))
    comb = torch.cat([L.rms_norm(p["norm_h"], h, cfg.norm_eps),
                      L.rms_norm(p["norm_e"], emb_next, cfg.norm_eps)], -1)
    x = L.linear(p["proj"], comb)
    kind = "moe" if (cfg.moe and "moe" in p["block"]) else "dense"
    x = block_train(p["block"], x, cfg, backend=backend, kind=kind)
    keep = torch.arange(S, device=tokens.device)[None, :] < S - 1
    return L.chunked_ce_loss(params["embed"], x,
                             torch.roll(targets, -1, dims=1),
                             mask * keep, cfg.tie_embeddings, cfg.loss_chunk)


def cache_descs(cfg: ModelConfig, batch: int, seq: int) -> List[Tree]:
    """The decode cache, in the activation dtype: a list of per-layer
    ``{"k", "v"}`` of shape (batch, seq, KH, D), or under MLA the latent
    cache ``{"ckv": (batch, seq, kv_lora_rank), "kr": (batch, seq,
    qk_rope_head_dim)}``."""
    check_family(cfg)
    if cfg.mla:
        shapes = {"ckv": (batch, seq, cfg.mla.kv_lora_rank),
                  "kr": (batch, seq, cfg.mla.qk_rope_head_dim)}
    else:
        shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    return [{n: ParamDesc(s, cfg.dtype, kv_axes(s), init="zeros")
             for n, s in shapes.items()} for _ in range(cfg.num_layers)]


def kv_axes(shape) -> Tuple[Optional[str], ...]:
    """A self-attention cache leaf's logical axes: batch, then the cached
    sequence, then the rest unsharded."""
    return ("batch", "kv_seq") + (None,) * (len(shape) - 2)


def lm_prefill(params, batch, cfg: ModelConfig,
               backend: Optional[str] = None
               ) -> Tuple[torch.Tensor, List[Tree]]:
    """Returns (last-token logits (B, V), per-layer cache of the prompt
    and its patch prefix: a list of ``{"k", "v"}`` of shape (B, n_prefix
    + S, KH, D), or of ``{"ckv", "kr"}`` under MLA)."""
    x, _ = _embed_input(params, batch, cfg)
    names = ("ckv", "kr") if cfg.mla else ("k", "v")
    cache = []
    for kind, lp in layers(params, cfg):
        x, kv = block_prefill(lp, x, cfg, backend=backend, kind=kind)
        cache.append(dict(zip(names, kv)))
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x[:, -1:, :],
                         cfg.tie_embeddings)[:, 0]
    return logits, cache


def lm_decode(params, token, pos, cache, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, List[Tree]]:
    """token: (B,1) int; pos: (B,) int, counting a patch prefix; cache
    from :func:`cache_descs`, whose tensors are updated in place. Returns
    (logits (B, V), cache')."""
    x = L.embed(params["embed"], token)
    new_cache = list(cache)
    for layer, (kind, lp) in enumerate(layers(params, cfg)):
        x, new = block_decode(lp, x, cfg, cache[layer], pos, kind=kind)
        new_cache[layer] = {n: t.to(cache[layer][n].dtype)
                            for n, t in new.items()}
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, new_cache
