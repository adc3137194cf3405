"""RWKV6 (Finch): attention-free time mix with data-dependent decay (the
port of ``repro.models.rwkv``).

Training uses the chunked linear-attention form (factorised per-channel
decay, f32, clipped exponents); decode is the O(1) recurrence carrying a
per-head (D, D) state plus the token-shift buffers. See
arXiv:2404.05892. The reference has no Pallas kernel for the scan, so the
port's is plain PyTorch.

Two of the reference's forms change shape here, not value:

* :func:`wkv6_chunked` takes every chunk at once where the reference maps
  over them (``lax.map``): the intra-chunk scores, their strict-lower
  mask, the bonus diagonal and the chunk states are batched products over
  (B, nc, H), and only the (B, H, D, D) f32 state walks the chunks in
  order. The reference's factorisation is kept: a = r exp(cs - lw), b =
  k exp(-cs) (clipped above only, up to e^60), so the scores are a . b,
  not exp(cs_t - cs_s) formed directly.
* :func:`time_mix_train` and :func:`rwkv6_block_train` with
  ``return_state`` also return the layer's decode state after the last
  position, which the reference's ``rwkv_prefill`` computes inline.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamDesc

Tree = Any
LORA_R = 32          # decay LoRA rank
MIX_R = 32           # token-shift mixing LoRA rank
CLIP = 60.0


def _heads(cfg: ModelConfig):
    """(H, D) of cfg's time mix."""
    D = cfg.resolved_head_dim
    return cfg.d_model // D, D


def rwkv6_descs(cfg: ModelConfig) -> Tree:
    """One RWKV6 block's parameters (``decay_base`` and ``bonus`` in f32,
    whatever the model's dtype)."""
    d = cfg.d_model
    dt = cfg.param_dtype
    H, D = _heads(cfg)
    proj_in = dict(in_axis="embed", out_axis="model")
    proj_out = dict(in_axis="model", out_axis="embed")
    return {
        "ln1": L.layer_norm_descs(d, dt),
        "ln2": L.layer_norm_descs(d, dt),
        "tm": {  # time mix
            # base token-shift lerp coefficients for (w,k,v,r,g) + ddlerp
            "maa_x": ParamDesc((d,), dt, (None,), init="zeros"),
            "maa_wkvrg": ParamDesc((5, d), dt, (None, None), init="zeros"),
            "maa_w1": ParamDesc((d, 5 * MIX_R), dt, ("embed", None)),
            "maa_w2": ParamDesc((5, MIX_R, d), dt, (None, None, "embed")),
            "decay_base": ParamDesc((H, D), "float32", (None, None),
                                    init="const", const=-4.0),
            "decay_w1": ParamDesc((d, LORA_R), dt, ("embed", None)),
            "decay_w2": ParamDesc((LORA_R, d), dt, (None, "embed")),
            "bonus": ParamDesc((H, D), "float32", (None, None), scale=1.0),
            "r": L.linear_descs(d, d, dt, **proj_in),
            "k": L.linear_descs(d, d, dt, **proj_in),
            "v": L.linear_descs(d, d, dt, **proj_in),
            "g": L.linear_descs(d, d, dt, **proj_in),
            "out": L.linear_descs(d, d, dt, **proj_out),
            "gn_scale": ParamDesc((d,), dt, (None,), init="ones"),
            "gn_bias": ParamDesc((d,), dt, (None,), init="zeros"),
        },
        "cm": {  # channel mix
            "maa_k": ParamDesc((d,), dt, (None,), init="zeros"),
            "maa_r": ParamDesc((d,), dt, (None,), init="zeros"),
            "k": L.linear_descs(d, cfg.d_ff, dt, **proj_in),
            "v": L.linear_descs(cfg.d_ff, d, dt, **proj_out),
            "r": L.linear_descs(d, d, dt, **proj_in),
        },
    }


def _token_shift(x, prev):
    """x: (B,S,d); prev: (B,d) the token before x[:, 0]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g), in
    x's dtype: (B,S,5,d)."""
    dx = xs - x
    xx = x + dx * p["maa_x"][None, None, :]
    a = torch.tanh(xx @ p["maa_w1"])                    # (B,S,5R)
    B_, S_, _ = a.shape
    a = a.reshape(B_, S_, 5, MIX_R)
    delta = torch.einsum("bsfr,frd->bsfd", a, p["maa_w2"])
    mix = p["maa_wkvrg"][None, None] + delta            # (B,S,5,d)
    return x[:, :, None, :] + dx[:, :, None, :] * mix


def _group_norm(x, scale, bias, H, eps=64e-5):
    """Per-head group norm over (B,T,H*D), in f32; the result in x's
    dtype."""
    B_, T_, d = x.shape
    xh = x.reshape(B_, T_, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(B_, T_, d) * scale + bias).to(x.dtype)


def wkv6_chunked(r, k, v, lw, u, chunk: int,
                 state0: Optional[torch.Tensor] = None):
    """Chunked WKV. r, k, v: (B,S,H,D) f32; lw: (B,S,H,D) per-step
    log-decay (<= 0); u: (H,D) bonus; ``state0``: an optional (B,H,D,D)
    state entering the first chunk. Returns (y (B,S,H,D), the final state
    (B,H,D,D) f32, keys on its third axis). The chunk length is the
    largest divisor of S that is at most ``chunk``, as in the
    reference."""
    B_, S_, H_, D_ = r.shape
    K = min(chunk, S_)
    while S_ % K:
        K -= 1
    nc = S_ // K

    def resh(t):                            # -> (B, nc, H, K, D)
        return t.reshape(B_, nc, K, H_, D_).transpose(2, 3)

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(lw)
    cs = torch.cumsum(lwc, dim=3)                       # inclusive
    a = rc * torch.exp(torch.clamp(cs - lwc, -CLIP, 0.0))
    b = kc * torch.exp(torch.clamp(-cs, max=CLIP))
    kdec = kc * torch.exp(torch.clamp(cs[..., -1:, :] - cs, -CLIP, 0.0))

    # intra-chunk: strictly earlier positions through the scores, the
    # diagonal through the bonus
    mask = torch.ones(K, K, dtype=torch.bool, device=r.device).tril(-1)
    sc = (a @ b.transpose(-1, -2)) * mask               # (B,nc,H,K,K)
    y = sc @ vc
    y = y + (rc * u[None, None, :, None, :] * kc).sum(-1, keepdim=True) * vc

    # chunk states S_c[d, e] = sum_s kdec_s[d] v_s[e], and the state
    # entering each chunk, in order
    S_chunks = kdec.transpose(-1, -2) @ vc              # (B,nc,H,D,D)
    chunk_decay = torch.exp(torch.clamp(cs[..., -1, :], -CLIP, 0.0))
    S = (state0.float() if state0 is not None
         else r.new_zeros((B_, H_, D_, D_), dtype=torch.float32))
    entering = []
    for c in range(nc):
        entering.append(S)
        S = S * chunk_decay[:, c, :, :, None] + S_chunks[:, c]
    y = y + a @ torch.stack(entering, dim=1)            # inter-chunk
    return y.transpose(2, 3).reshape(B_, S_, H_, D_), S


def _tm_wkvrg(p, x, xs, cfg: ModelConfig):
    """Projections + decay for the time mix. Returns r, k, v (f32), g (x's
    dtype) and lw (f32), each (B,S,H,D) but g (B,S,d)."""
    H, D = _heads(cfg)
    B_, S_, _ = x.shape
    mixed = _ddlerp(p, x, xs)                           # (B,S,5,d)
    xw, xk, xv, xr, xg = mixed.unbind(2)
    r = L.linear(p["r"], xr).reshape(B_, S_, H, D).float()
    k = L.linear(p["k"], xk).reshape(B_, S_, H, D).float()
    v = L.linear(p["v"], xv).reshape(B_, S_, H, D).float()
    g = F.silu(L.linear(p["g"], xg))
    dec = p["decay_base"][None, None] + (
        torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]).reshape(
            B_, S_, H, D).float()
    lw = -torch.exp(torch.clamp(dec, -8.0, 8.0))        # log w <= 0
    return r, k, v, g, lw


def time_mix_train(p, x, cfg: ModelConfig, chunk: int,
                   return_state: bool = False):
    """x: (B,S,d) normed input -> (B,S,d); the token shift starts from
    zeros. ``return_state``: also (the last input in f32, the wkv state
    after the last position)."""
    B_, S_, d = x.shape
    H, _ = _heads(cfg)
    xs = _token_shift(x, x.new_zeros((B_, d)))
    r, k, v, g, lw = _tm_wkvrg(p, x, xs, cfg)
    y, state = wkv6_chunked(r, k, v, lw, p["bonus"].float(), chunk)
    y = _group_norm(y.reshape(B_, S_, d).to(x.dtype), p["gn_scale"],
                    p["gn_bias"], H)
    out = L.linear(p["out"], y * g)
    if return_state:
        return out, (x[:, -1].float(), state)
    return out


def _channel_mix(p, x, xs):
    """The channel mix of x: (B,S,d) with the shifted input xs."""
    xk = x + (xs - x) * p["maa_k"][None, None]
    xr = x + (xs - x) * p["maa_r"][None, None]
    k = torch.square(F.relu(L.linear(p["k"], xk)))
    return torch.sigmoid(L.linear(p["r"], xr)) * L.linear(p["v"], k)


def channel_mix_train(p, x, cfg: ModelConfig):
    B_, _, d = x.shape
    return _channel_mix(p, x, _token_shift(x, x.new_zeros((B_, d))))


def rwkv6_state_descs(cfg: ModelConfig, batch: int) -> Tree:
    """One layer's decode state, f32 zeros: the time and channel mixes'
    last inputs and the (batch, H, D, D) wkv state."""
    H, D = _heads(cfg)
    z = lambda shape, axes: ParamDesc(shape, "float32", axes, init="zeros")
    return {"tm_x": z((batch, cfg.d_model), ("batch", None)),
            "cm_x": z((batch, cfg.d_model), ("batch", None)),
            "wkv": z((batch, H, D, D), ("batch", None, None, None))}


def rwkv6_block_train(params, x, cfg: ModelConfig,
                      return_state: bool = False):
    """One block over x: (B,S,d) from a zero state. ``return_state``: also
    the block's decode state after the last position
    (:func:`rwkv6_state_descs`)."""
    xn = L.layer_norm(params["ln1"], x, cfg.norm_eps)
    y = time_mix_train(params["tm"], xn, cfg, cfg.ssm.chunk_size,
                       return_state=return_state)
    h = x + (y[0] if return_state else y)
    hn = L.layer_norm(params["ln2"], h, cfg.norm_eps)
    h = h + channel_mix_train(params["cm"], hn, cfg)
    if return_state:
        tm_x, wkv = y[1]
        return h, {"tm_x": tm_x, "cm_x": hn[:, -1].float(), "wkv": wkv}
    return h


def rwkv6_block_decode(params, x, cfg: ModelConfig,
                       state: Dict[str, torch.Tensor]):
    """x: (B,1,d); state from :func:`rwkv6_state_descs` -> (y, state'):
    the recurrence at one position; the decay scales the state's key rows
    (its third axis)."""
    B_, _, d = x.shape
    H, _ = _heads(cfg)
    xn = L.layer_norm(params["ln1"], x, cfg.norm_eps)
    xs = state["tm_x"].to(xn.dtype)[:, None, :]
    p = params["tm"]
    r, k, v, g, lw = _tm_wkvrg(p, xn, xs, cfg)
    r, k, v, lw = r[:, 0], k[:, 0], v[:, 0], lw[:, 0]   # (B,H,D)
    u = p["bonus"].float()
    S = state["wkv"]                                    # (B,H,D,D)
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhd,bhde->bhe", r, S + u[None, :, :, None] * kv)
    S = S * torch.exp(lw)[..., None] + kv
    y = _group_norm(y.reshape(B_, 1, d).to(x.dtype), p["gn_scale"],
                    p["gn_bias"], H)
    h = x + L.linear(p["out"], y * g)
    hn = L.layer_norm(params["ln2"], h, cfg.norm_eps)
    h = h + _channel_mix(params["cm"], hn,
                         state["cm_x"].to(hn.dtype)[:, None, :])
    return h, {"tm_x": xn[:, 0].float(), "cm_x": hn[:, 0].float(),
               "wkv": S}
