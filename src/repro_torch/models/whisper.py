"""whisper-tiny encoder-decoder (the port of ``repro.models.whisper``).

The conv/mel frontend is a STUB: batches carry precomputed frame
embeddings (B, F, d_model) (``data.tokens.add_modality_stub``). A pre-LN
transformer with learned positions, GELU MLPs and cross attention.

The encoder's self-attention is full (non-causal) and the decoder's
causal, both without rope and both through ``attention.attn_train``, so on
the card they launch K6 (and K7 in the backward); cross attention is
``attention.full_attention``, plain PyTorch as in the reference. The
parameters keep the reference's layout (encoder and decoder blocks stacked
(L, ...), walked after one ``lm.unstack``). Under ``cfg.remat == "full"``
and autograd each decoder block is recomputed in the backward
(``torch.utils.checkpoint``); the encoder is not, as in the reference. The
decode cache is the reference's list of per-layer ``{"k", "v", "xk",
"xv"}``: the decoder's self-attention K/V along the sequence and the
cross-attention K/V over the frames, made once by the prefill.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.lm import loss_mask, unstack
from repro_torch.models.param import ParamDesc

Tree = Any


def _enc_block_descs(cfg: ModelConfig) -> Tree:
    return {"ln1": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
            "attn": A.attn_descs(cfg),
            "ln2": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
            "ffn": L.ffn_descs(cfg)}


def _dec_block_descs(cfg: ModelConfig) -> Tree:
    t = _enc_block_descs(cfg)
    t["ln_x"] = L.layer_norm_descs(cfg.d_model, cfg.param_dtype)
    t["xattn"] = A.attn_descs(cfg)
    return t


def whisper_descs(cfg: ModelConfig) -> Tree:
    e = cfg.encdec
    return {
        "embed": L.embed_descs(cfg),
        "pos_dec": ParamDesc((4096 if cfg.vocab_size > 1000 else 64,
                              cfg.d_model), cfg.param_dtype, init="embed"),
        "pos_enc": ParamDesc((e.num_frames, cfg.d_model), cfg.param_dtype,
                             init="embed"),
        "encoder": L.stack_descs(_enc_block_descs(cfg), e.num_encoder_layers),
        "enc_norm": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
        "decoder": L.stack_descs(_dec_block_descs(cfg), cfg.num_layers),
        "final_norm": L.layer_norm_descs(cfg.d_model, cfg.param_dtype),
    }


def encode(params, frames, cfg: ModelConfig,
           backend: Optional[str] = None) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder states (B, F, d):
    full self-attention without rope."""
    F = frames.shape[1]
    x = frames + params["pos_enc"][None, :F]
    for lp in unstack(params["encoder"], cfg.encdec.num_encoder_layers):
        hn = L.layer_norm(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attn_train(lp["attn"], hn, cfg, causal=False, rope=False,
                             backend=backend)
        hn = L.layer_norm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.ffn(lp["ffn"], hn, cfg.act)
    return L.layer_norm(params["enc_norm"], x, cfg.norm_eps)


def _dec_positions(params, S: int, device) -> torch.Tensor:
    """The learned positions of 0..S-1, clipped to the table's last row."""
    table = params["pos_dec"]
    idx = torch.arange(S, device=device).clamp(max=table.shape[0] - 1)
    return table[idx]


def _cross_kv(lp, enc, cfg: ModelConfig):
    """The cross attention's K and V over the encoder states: (B, F, KH,
    D) each."""
    B, F, _ = enc.shape
    D = cfg.resolved_head_dim
    k = L.linear(lp["xattn"]["k"], enc).reshape(B, F, cfg.num_kv_heads, D)
    v = L.linear(lp["xattn"]["v"], enc).reshape(B, F, cfg.num_kv_heads, D)
    return k, v


def _cross_attend(lp, h, xk, xv, cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = h.shape
    D = cfg.resolved_head_dim
    q = L.linear(lp["xattn"]["q"], h).reshape(B, S, cfg.num_heads, D)
    o = A.full_attention(q, xk, xv)
    return L.linear(lp["xattn"]["o"], o.reshape(B, S, -1))


def _dec_block(lp, x, enc, cfg: ModelConfig, backend: Optional[str] = None,
               return_kv: bool = False):
    """One decoder block: causal self-attention, cross attention over
    ``enc``, FFN. ``return_kv``: also (k, v, xk, xv) for the cache."""
    hn = L.layer_norm(lp["ln1"], x, cfg.norm_eps)
    out = A.attn_train(lp["attn"], hn, cfg, causal=True, rope=False,
                       return_kv=return_kv, backend=backend)
    a, kv = out if return_kv else (out, None)
    x = x + a
    hn = L.layer_norm(lp["ln_x"], x, cfg.norm_eps)
    xk, xv = _cross_kv(lp, enc, cfg)
    x = x + _cross_attend(lp, hn, xk, xv, cfg)
    hn = L.layer_norm(lp["ln2"], x, cfg.norm_eps)
    x = x + L.ffn(lp["ffn"], hn, cfg.act)
    return (x, kv + (xk, xv)) if return_kv else x


def decoder_hidden(params, tokens, enc, cfg: ModelConfig,
                   backend: Optional[str] = None) -> torch.Tensor:
    """The decoder's final hidden states (B, S, d) over ``tokens``."""
    x = L.embed(params["embed"], tokens) + _dec_positions(
        params, tokens.shape[1], tokens.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in unstack(params["decoder"], cfg.num_layers):
        x = (checkpoint(_dec_block, lp, x, enc, cfg, backend,
                        use_reentrant=False)
             if remat else _dec_block(lp, x, enc, cfg, backend))
    return L.layer_norm(params["final_norm"], x, cfg.norm_eps)


def whisper_hidden(params, batch, cfg: ModelConfig,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Encode ``batch["frames"]``, then the decoder's final hidden states
    over ``batch["tokens"]``."""
    enc = encode(params, batch["frames"], cfg, backend)
    return decoder_hidden(params, batch["tokens"], enc, cfg, backend)


def whisper_loss(params, batch, cfg: ModelConfig,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"},
    an optional "mask", and "frames" (B, F, d)), f32 0-d."""
    x = whisper_hidden(params, batch, cfg, backend)
    return L.chunked_ce_loss(params["embed"], x, batch["targets"],
                             loss_mask(batch), cfg.tie_embeddings,
                             cfg.loss_chunk)


def whisper_cache_descs(cfg: ModelConfig, batch: int, seq: int) -> List[Tree]:
    """A list of per-layer caches in the activation dtype: the
    self-attention's K/V (batch, seq, KH, D) and the cross attention's
    (batch, F, KH, D)."""
    D = cfg.resolved_head_dim
    kv = (batch, seq, cfg.num_kv_heads, D)
    xkv = (batch, cfg.encdec.num_frames, cfg.num_kv_heads, D)
    return [{"k": ParamDesc(kv, cfg.dtype, init="zeros"),
             "v": ParamDesc(kv, cfg.dtype, init="zeros"),
             "xk": ParamDesc(xkv, cfg.dtype, init="zeros"),
             "xv": ParamDesc(xkv, cfg.dtype, init="zeros")}
            for _ in range(cfg.num_layers)]


def whisper_prefill(params, batch, cfg: ModelConfig,
                    backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, List[Tree]]:
    """Encode the frames and run the decoder over the prompt. Returns
    (last-token logits (B, V), the cache of :func:`whisper_cache_descs`
    over the prompt's length)."""
    enc = encode(params, batch["frames"], cfg, backend)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens) + _dec_positions(
        params, tokens.shape[1], tokens.device)
    cache = []
    for lp in unstack(params["decoder"], cfg.num_layers):
        x, kv = _dec_block(lp, x, enc, cfg, backend, return_kv=True)
        cache.append(dict(zip(("k", "v", "xk", "xv"), kv)))
    x = L.layer_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x[:, -1:, :],
                         cfg.tie_embeddings)[:, 0]
    return logits, cache


def whisper_decode(params, token, pos, cache, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, List[Tree]]:
    """token: (B,1) int; pos: (B,) int (its learned position clipped to
    the table); cache from :func:`whisper_cache_descs`, whose
    self-attention K/V are updated in place. Returns (logits (B, V),
    cache')."""
    table = params["pos_dec"]
    x = L.embed(params["embed"], token) + table[
        pos.clamp(0, table.shape[0] - 1)][:, None, :]
    B = x.shape[0]
    for lp, lc in zip(unstack(params["decoder"], cfg.num_layers), cache):
        hn = L.layer_norm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = A.project_qkv(lp["attn"], hn, cfg, None, rope=False)
        out, _, _ = A.flash_decode(q[:, 0], lc["k"], lc["v"], k[:, 0],
                                   v[:, 0], pos)
        x = x + L.linear(lp["attn"]["o"], out.reshape(B, 1, -1))
        hn = L.layer_norm(lp["ln_x"], x, cfg.norm_eps)
        x = x + _cross_attend(lp, hn, lc["xk"], lc["xv"], cfg)
        hn = L.layer_norm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.ffn(lp["ffn"], hn, cfg.act)
    x = L.layer_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.logits_fn(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, cache
