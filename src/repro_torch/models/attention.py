"""Attention, dense GQA/MQA/MHA subset with RoPE, qk-norm and biases (the
port of ``repro.models.attention``).

Two execution paths:
  * train/prefill — :func:`chunked_attention`, causal flash attention
    through the flash_attention kernel family (K6 on the card).
  * decode       — :func:`flash_decode`, one token against the KV cache in
    plain PyTorch (the reference's is pure JAX under ``shard_map``; on one
    device its pmax/psum combine is the identity).

The reference's MLA (deepseek-v3) and cross attention (whisper) are not
ported (ROADMAP §1 item 14).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L

Tree = Any
NEG_INF = -1e30


def attn_descs(cfg: ModelConfig) -> Tree:
    D = cfg.resolved_head_dim
    dt = cfg.param_dtype
    t = {"q": L.linear_descs(cfg.d_model, cfg.num_heads * D, dt,
                             bias=cfg.qkv_bias),
         "k": L.linear_descs(cfg.d_model, cfg.num_kv_heads * D, dt,
                             bias=cfg.qkv_bias),
         "v": L.linear_descs(cfg.d_model, cfg.num_kv_heads * D, dt,
                             bias=cfg.qkv_bias),
         "o": L.linear_descs(cfg.num_heads * D, cfg.d_model, dt)}
    if cfg.qk_norm:
        t["q_norm"] = L.rms_norm_descs(D, dt)
        t["k_norm"] = L.rms_norm_descs(D, dt)
    return t


def chunked_attention(q, k, v, *, q_offset: int = 0,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Causal flash attention. q: (B,Sq,H,D); k: (B,Sk,KH,D); v:
    (B,Sk,KH,Dv) -> (B,Sq,H,Dv). Query head h reads kv head h // (H // KH), as in the
    reference. The kernel keeps the TPU kernel's top-left causal mask, so
    a query offset is refused rather than added."""
    if q_offset:
        raise NotImplementedError(
            "q_offset != 0: the flash kernel masks top-left (query i sees "
            "keys 0..i), as the TPU kernel does")
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    # (B, S, H, D) -> (B*H, S, D): bh = b*H + kh*G + g, so bh // G is the
    # row b*KH + kh of k/v flattened the same way
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = k.transpose(1, 2).reshape(B * KH, Sk, D)
    vf = v.transpose(1, 2).reshape(B * KH, Sk, Dv)
    o = flash_attention(qf, kf, vf, group=H // KH, backend=backend)
    return o.reshape(B, H, Sq, Dv).transpose(1, 2)


def flash_decode(q, k_cache, v_cache, k_new, v_new, pos):
    """One decode step against the KV cache, on one device.

    q:       (B, H, D)      — current-token queries.
    k_cache: (B, S, KH, D)  — updated IN PLACE: this step's K/V row is
                              written at ``pos`` (the reference returns a
                              new cache and donates the old one).
    k_new:   (B, KH, D)
    pos:     (B,) int       — per-sequence write/attend position; a
                              position outside [0, S) writes nothing.
    Returns (out (B, H, D), k_cache, v_cache).
    """
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = D ** -0.5
    rows = torch.arange(B, device=q.device)
    valid = ((pos >= 0) & (pos < S))[:, None, None]
    idx = pos.clamp(0, S - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, idx] = torch.where(valid, new.to(cache.dtype),
                                       cache[rows, idx])
    qr = q.reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None] <= pos[:, None])
    mask = mask[:, None, None]                               # (B,1,1,S)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                           # (B,KH,G)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", e.to(v_cache.dtype).float(),
                     v_cache.float())
    out = (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, H, D), k_cache, v_cache


def project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,KH,D) with rope + qk-norm."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    q = L.linear(params["q"], x).reshape(B, S, cfg.num_heads, D)
    k = L.linear(params["k"], x).reshape(B, S, cfg.num_kv_heads, D)
    v = L.linear(params["v"], x).reshape(B, S, cfg.num_kv_heads, D)
    if cfg.qk_norm:
        q = L.rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(params["k_norm"], k, cfg.norm_eps)
    cos, sin = L.rotary(positions, D, cfg.rope_theta)
    return L.apply_rotary(q, cos, sin), L.apply_rotary(k, cos, sin), v


def attn_train(params, x, cfg: ModelConfig, *, return_kv: bool = False,
               backend: Optional[str] = None):
    """Causal self-attention over positions 0..S-1 of x: (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = project_qkv(params, x, cfg, torch.arange(S, device=x.device))
    o = chunked_attention(q, k, v, backend=backend)
    y = L.linear(params["o"], o.reshape(B, S, -1))
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(params, x, cfg: ModelConfig, k_cache, v_cache, pos):
    """x: (B,1,d); pos: (B,) — returns (y (B,1,d), k_cache', v_cache');
    the caches are updated in place."""
    B = x.shape[0]
    q, k, v = project_qkv(params, x, cfg, pos[:, None].float())
    out, k_cache, v_cache = flash_decode(q[:, 0], k_cache, v_cache, k[:, 0],
                                         v[:, 0], pos)
    y = L.linear(params["o"], out.reshape(B, 1, -1))
    return y, k_cache, v_cache
