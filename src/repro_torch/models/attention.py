"""Attention: GQA/MQA/MHA with RoPE, qk-norm and biases, and MLA
(deepseek-v3) (the port of ``repro.models.attention``).

Three execution paths:
  * train/prefill — :func:`chunked_attention`, causal or full (whisper's
    encoder) flash attention through the flash_attention kernel family
    (K6 on the card); MLA's prefill (:func:`mla_train`) expands the
    latent to per-head K/V of head dim nope + rope = 192 and Dv = 128 at
    full width.
  * decode       — :func:`flash_decode` (one token against the KV cache)
    and :func:`mla_decode` (the absorbed form over the latent cache), in
    plain PyTorch: the reference's are pure JAX under ``shard_map``, and
    on one device their pmax/psum combine is the identity.
  * cross        — :func:`full_attention` (whisper's cross attention),
    plain PyTorch as the reference's is a plain einsum outside any Pallas
    kernel: it rounds the normalised p to v's dtype before p . v, where
    K6 rounds the unnormalised exp(s - m).
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
    qkv = dict(bias=cfg.qkv_bias, in_axis="embed", out_axis="model")
    t = {"q": L.linear_descs(cfg.d_model, cfg.num_heads * D, dt, **qkv),
         "k": L.linear_descs(cfg.d_model, cfg.num_kv_heads * D, dt, **qkv),
         "v": L.linear_descs(cfg.d_model, cfg.num_kv_heads * D, dt, **qkv),
         "o": L.linear_descs(cfg.num_heads * D, cfg.d_model, dt,
                             in_axis="model", out_axis="embed")}
    if cfg.qk_norm:
        t["q_norm"] = L.rms_norm_descs(D, dt)
        t["k_norm"] = L.rms_norm_descs(D, dt)
    return t


def chunked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      scale: Optional[float] = None,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Flash attention, causal or (``causal=False``) full. q: (B,Sq,H,D);
    k: (B,Sk,KH,D); v: (B,Sk,KH,Dv) -> (B,Sq,H,Dv). Query head h reads kv
    head h // (H // KH), as in the reference; ``scale`` defaults to
    D ** -0.5. The kernel keeps the TPU kernel's top-left causal mask, so
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
    o = flash_attention(qf, kf, vf, group=H // KH, causal=causal,
                        scale=scale, backend=backend)
    return o.reshape(B, H, Sq, Dv).transpose(1, 2)


def full_attention(q, k, v, *, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """Small unmasked attention (cross attention), as the reference
    computes it: f32 scores, softmax, p rounded to v's dtype, then p . v
    in v's dtype. q: (B,Sq,H,D); k/v: (B,Sk,KH,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqkgd,bckd->bkgqc", qr.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v)
    return o.reshape(B, Sq, H, D)


def _update_rows(cache, new, pos) -> None:
    """Write ``new[b]`` into ``cache[b, pos[b]]`` in place for every b whose
    position lies in [0, S); other rows are left as they were."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    valid = ((pos >= 0) & (pos < S)).reshape((-1,) + (1,) * (new.ndim - 1))
    idx = pos.clamp(0, S - 1)
    cache[rows, idx] = torch.where(valid, new.to(cache.dtype),
                                   cache[rows, idx])


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
    _update_rows(k_cache, k_new, pos)
    _update_rows(v_cache, v_new, pos)
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


def project_qkv(params, x, cfg: ModelConfig, positions, rope: bool = True):
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,KH,D) with qk-norm and (unless
    ``rope`` is False) rope."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    q = L.linear(params["q"], x).reshape(B, S, cfg.num_heads, D)
    k = L.linear(params["k"], x).reshape(B, S, cfg.num_kv_heads, D)
    v = L.linear(params["v"], x).reshape(B, S, cfg.num_kv_heads, D)
    if cfg.qk_norm:
        q = L.rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(params["k_norm"], k, cfg.norm_eps)
    if not rope:
        return q, k, v
    cos, sin = L.rotary(positions, D, cfg.rope_theta)
    return L.apply_rotary(q, cos, sin), L.apply_rotary(k, cos, sin), v


def attn_train(params, x, cfg: ModelConfig, *, causal: bool = True,
               rope: bool = True, return_kv: bool = False,
               backend: Optional[str] = None):
    """Self-attention over positions 0..S-1 of x: (B,S,d), causal or
    (``causal=False``) full, with rope unless ``rope`` is False."""
    B, S, _ = x.shape
    q, k, v = project_qkv(params, x, cfg, torch.arange(S, device=x.device),
                          rope=rope)
    o = chunked_attention(q, k, v, causal=causal, backend=backend)
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


# ---------------------------------------------------------------- MLA ------

def mla_descs(cfg: ModelConfig) -> Tree:
    m = cfg.mla
    dt = cfg.param_dtype
    H = cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_down": L.linear_descs(cfg.d_model, m.q_lora_rank, dt,
                                 in_axis="embed"),
        "q_norm": L.rms_norm_descs(m.q_lora_rank, dt),
        "q_up": L.linear_descs(m.q_lora_rank, H * qk_dim, dt,
                               out_axis="model"),
        "kv_down": L.linear_descs(cfg.d_model,
                                  m.kv_lora_rank + m.qk_rope_head_dim, dt,
                                  in_axis="embed"),
        "kv_norm": L.rms_norm_descs(m.kv_lora_rank, dt),
        "k_up": L.linear_descs(m.kv_lora_rank, H * m.qk_nope_head_dim, dt,
                               out_axis="model"),
        "v_up": L.linear_descs(m.kv_lora_rank, H * m.v_head_dim, dt,
                               out_axis="model"),
        "o": L.linear_descs(H * m.v_head_dim, cfg.d_model, dt,
                            in_axis="model", out_axis="embed"),
    }


def _mla_qkv_latent(params, x, cfg: ModelConfig, positions):
    """The shared down-projections. x: (B,S,d) -> q_nope (B,S,H,nope),
    q_rope (B,S,H,rope) rotated, the normed latent c_kv (B,S,R) and k_rope
    (B,S,rope) rotated."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    ql = L.rms_norm(params["q_norm"], L.linear(params["q_down"], x),
                    cfg.norm_eps)
    q = L.linear(params["q_up"], ql).reshape(B, S, H, qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv = L.linear(params["kv_down"], x)
    c_kv = L.rms_norm(params["kv_norm"], kv[..., :m.kv_lora_rank],
                      cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:]
    cos, sin = L.rotary(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = L.apply_rotary(q_rope, cos, sin)
    k_rope = L.apply_rotary(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_train(params, x, cfg: ModelConfig, *, return_kv: bool = False,
              backend: Optional[str] = None):
    """Training/prefill MLA over positions 0..S-1 of x: (B,S,d). The latent
    is expanded to per-head K (nope, then the shared rope part) and V, and
    attention runs through K6 at head dim nope + rope with Dv = v_head_dim
    and scale (nope + rope) ** -0.5. ``return_kv``: also the latent cache
    entries (c_kv (B,S,R), k_rope (B,S,rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(
        params, x, cfg, torch.arange(S, device=x.device))
    k_nope = L.linear(params["k_up"], c_kv).reshape(B, S, H,
                                                    m.qk_nope_head_dim)
    v = L.linear(params["v_up"], c_kv).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = chunked_attention(q, k, v, scale=_mla_scale(cfg), backend=backend)
    y = L.linear(params["o"], o.reshape(B, S, -1))
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(params, x, cfg: ModelConfig, ckv_cache, krope_cache, pos):
    """Absorbed-weight MLA decode over the latent cache, on one device.

    x: (B,1,d); pos: (B,) int; ckv_cache: (B,S,R) and krope_cache:
    (B,S,rope), updated IN PLACE with this step's row at ``pos``. The
    query absorbs k_up (q_abs = q_nope · W_k), scores run over the latent
    and the rope caches, and the latent-space output leaves through v_up.
    Returns (y (B,1,d), ckv_cache, krope_cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    R = m.kv_lora_rank
    S = ckv_cache.shape[1]
    q_nope, q_rope, c_new, kr_new = _mla_qkv_latent(
        params, x, cfg, pos[:, None].float())
    wk = params["k_up"]["w"].reshape(R, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk)   # (B,H,R)
    _update_rows(ckv_cache, c_new[:, 0], pos)
    _update_rows(krope_cache, kr_new[:, 0], pos)
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), ckv_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                        krope_cache.float())) * _mla_scale(cfg)
    mask = (torch.arange(S, device=x.device)[None] <= pos[:, None])[:, None]
    s = torch.where(mask, s, NEG_INF)
    mx = s.amax(-1)
    e = torch.where(mask, torch.exp(s - mx[..., None]), 0.0)
    l = e.sum(-1)
    o = torch.einsum("bhs,bsr->bhr", e.to(ckv_cache.dtype).float(),
                     ckv_cache.float())                       # latent space
    o_lat = (o / l.clamp(min=1e-30)[..., None]).to(x.dtype)
    wv = params["v_up"]["w"].reshape(R, H, m.v_head_dim)
    o = torch.einsum("bhr,rhp->bhp", o_lat, wv)
    y = L.linear(params["o"], o.reshape(B, 1, -1))
    return y, ckv_cache, krope_cache
