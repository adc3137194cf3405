"""Mamba2 (SSD, state-space duality) blocks for the zamba2 hybrid (the
port of ``repro.models.ssm``).

Chunked-scan training form (minimal SSD): the sequence is split into
chunks; within a chunk the output is a masked-decay product, across chunks
an f32 (H, P, N) state carries. Decode is the O(1) recurrent update. The
state math runs in f32. The reference has no Pallas kernel for the scan,
so the port's is plain PyTorch.

Two of the reference's forms change shape here, not value:

* :func:`ssd_chunked` takes every chunk at once where the reference maps
  over them (``lax.map``): the intra-chunk term is the group scores times
  the masked decay, (b, nc, H, K, K), then one batched product over the
  key positions; the chunk states are one batched product too, and only
  the (b, H, P, N) state's recurrence walks the chunks in order. B and C
  stay in group form throughout.
* :func:`mamba2_train` with ``return_state`` also returns the layer's
  decode state, which the reference's ``hybrid_prefill`` computes inline.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamDesc

Tree = Any
CLIP = -60.0        # the reference clips every log-decay to [-60, 0]


def _dims(cfg: ModelConfig):
    """(d_inner, H, G * N) of cfg's Mamba2 block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.n_groups * s.state_dim


def mamba2_descs(cfg: ModelConfig) -> Tree:
    """One Mamba2 block's parameters (``A_log``'s constant 0 as zeros)."""
    s = cfg.ssm
    dt = cfg.param_dtype
    d = cfg.d_model
    d_inner, H, gn = _dims(cfg)
    conv = lambda c, ax: {"w": ParamDesc((s.conv_width, c), dt, (None, ax),
                                         init="normal", scale=0.5),
                          "b": ParamDesc((c,), dt, (ax,), init="zeros")}
    return {
        "in_z": L.linear_descs(d, d_inner, dt, in_axis="embed",
                               out_axis="model"),
        "in_x": L.linear_descs(d, d_inner, dt, in_axis="embed",
                               out_axis="model"),
        "in_b": L.linear_descs(d, gn, dt, in_axis="embed"),
        "in_c": L.linear_descs(d, gn, dt, in_axis="embed"),
        "in_dt": L.linear_descs(d, H, dt, in_axis="embed"),
        "conv_x": conv(d_inner, "model"),
        "conv_b": conv(gn, None),
        "conv_c": conv(gn, None),
        "A_log": ParamDesc((H,), "float32", (None,), init="zeros"),
        "D": ParamDesc((H,), "float32", (None,), init="ones"),
        "dt_bias": ParamDesc((H,), "float32", (None,), init="zeros"),
        "norm": L.rms_norm_descs(d_inner, dt),
        "out": L.linear_descs(d_inner, d, dt, in_axis="model",
                              out_axis="embed"),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,C); w: (W,C) -> (B,S,C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):                      # W is tiny (4): unrolled taps
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _conv_step(x_t, conv_state, w, b):
    """x_t: (B,C); conv_state: (B,W-1,C) last inputs -> (y (B,C), state')."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B,W,C)
    y = torch.einsum("bwc,wc->bc", full, w) + b[None, :]
    return y, full[:, 1:, :]


def ssd_chunked(x, dt, A, B, C, D, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """SSD scan. x: (b,s,H,P) f32; dt: (b,s,H) f32 (already softplus'ed);
    A: (H,) negative; B, C: (b,s,G,N); D: (H,); ``state0``: an optional
    (b,H,P,N) state entering the first chunk. Returns (y (b,s,H,P), the
    final state (b,H,P,N) f32). The chunk length is the largest divisor
    of s that is at most ``chunk``, as in the reference."""
    b, s, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    K = min(chunk, s)
    while s % K:
        K -= 1
    nc = s // K

    # (b, s, ...) -> (b, nc, K, ...)
    xc = x.reshape(b, nc, K, H, Pd)
    Bg = B.reshape(b, nc, K, G, N).transpose(2, 3)        # (b,nc,G,K,N)
    Cg = C.reshape(b, nc, K, G, N).transpose(2, 3)
    dtc = dt.reshape(b, nc, K, H)
    dA = dtc * A[None, None, None, :]                     # <= 0
    lw = torch.cumsum(dA, dim=2).transpose(2, 3)          # (b,nc,H,K) incl.
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)    # (b,nc,H,K,P)

    # intra-chunk: y[t] = sum_{s' <= t} (C_t . B_s') exp(lw_t - lw_s') xdt_s'
    sc = Cg @ Bg.transpose(-1, -2)                        # (b,nc,G,K,K)
    dec = torch.exp(torch.clamp(lw[..., :, None] - lw[..., None, :], CLIP,
                                0.0))                     # (b,nc,H,K,K)
    mask = torch.ones(K, K, dtype=torch.bool, device=x.device).tril()
    w = (sc[:, :, :, None] * dec.reshape(b, nc, G, rep, K, K)) * mask
    y_diag = w.reshape(b, nc, H, K, K) @ xdt              # (b,nc,H,K,P)

    # chunk states: S_c = sum_s exp(lw_last - lw_s) B_s xdt_s
    to_end = torch.exp(torch.clamp(lw[..., -1:] - lw, CLIP, 0.0))
    xd = (xdt * to_end[..., None]).reshape(b, nc, G, rep, K, Pd)
    S_chunks = (xd.transpose(-1, -2) @ Bg[:, :, :, None]).reshape(
        b, nc, H, Pd, N)
    chunk_decay = torch.exp(torch.clamp(lw[..., -1], CLIP, 0.0))  # (b,nc,H)

    # the state entering each chunk, in order
    S = (state0.float() if state0 is not None
         else x.new_zeros((b, H, Pd, N), dtype=torch.float32))
    entering = []
    for c in range(nc):
        entering.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_chunks[:, c]
    S_in = torch.stack(entering, dim=1).reshape(b, nc, G, rep, Pd, N)

    # inter-chunk: y[t] += exp(lw_t) C_t . S_in
    dec_h = torch.exp(torch.clamp(lw, CLIP, 0.0))         # (b,nc,H,K)
    y_off = (Cg[:, :, :, None] @ S_in.transpose(-1, -2)).reshape(
        b, nc, H, K, Pd) * dec_h[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, H, Pd)
    return y + x * D[None, None, :, None], S


def mamba2_train(params, x, cfg: ModelConfig, *, return_state: bool = False):
    """x: (B,S,d) -> (B,S,d). ``return_state``: also the layer's decode
    state after the last position (:func:`mamba2_state_descs`): the scan's
    final state and, for each conv, its last W - 1 inputs (the linear
    outputs before the conv) in f32."""
    s = cfg.ssm
    Bsz, S, d = x.shape
    d_inner, H, _ = _dims(cfg)
    z = L.linear(params["in_z"], x)
    xin = L.linear(params["in_x"], x)
    Bv = L.linear(params["in_b"], x)
    Cv = L.linear(params["in_c"], x)
    dt = L.linear(params["in_dt"], x)
    if return_state:
        tail = -(s.conv_width - 1)
        state = {"conv_x": xin[:, tail:].float(),
                 "conv_b": Bv[:, tail:].float(),
                 "conv_c": Cv[:, tail:].float()}
    xin = F.silu(_causal_conv(xin, params["conv_x"]["w"],
                              params["conv_x"]["b"]))
    Bv = F.silu(_causal_conv(Bv, params["conv_b"]["w"],
                             params["conv_b"]["b"]))
    Cv = F.silu(_causal_conv(Cv, params["conv_c"]["w"],
                             params["conv_c"]["b"]))
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    xh = xin.float().reshape(Bsz, S, H, s.head_dim)
    Bh = Bv.float().reshape(Bsz, S, s.n_groups, s.state_dim)
    Ch = Cv.float().reshape(Bsz, S, s.n_groups, s.state_dim)
    y, ssm_state = ssd_chunked(xh, dt, A, Bh, Ch, params["D"], s.chunk_size)
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = L.rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(params["out"], y)
    if return_state:
        return out, {"ssm": ssm_state, **state}
    return out


def mamba2_state_descs(cfg: ModelConfig, batch: int) -> Tree:
    """One layer's decode state, f32 zeros: the scan's (batch, H, P, N)
    and each conv's last W - 1 inputs."""
    s = cfg.ssm
    d_inner, H, gn = _dims(cfg)
    W = s.conv_width
    z = lambda shape, axes: ParamDesc(shape, "float32", axes, init="zeros")
    return {"ssm": z((batch, H, s.head_dim, s.state_dim),
                     ("batch", None, None, None)),
            "conv_x": z((batch, W - 1, d_inner), ("batch", None, "model")),
            "conv_b": z((batch, W - 1, gn), ("batch", None, None)),
            "conv_c": z((batch, W - 1, gn), ("batch", None, None))}


def mamba2_decode(params, x, cfg: ModelConfig, state: Dict[str, torch.Tensor]):
    """x: (B,1,d); state: dict from :func:`mamba2_state_descs` -> (y
    (B,1,d), state'): the recurrent update at one position, the conv
    weights and the state in f32."""
    s = cfg.ssm
    Bsz = x.shape[0]
    d_inner, H, _ = _dims(cfg)
    z = L.linear(params["in_z"], x)[:, 0]
    xin = L.linear(params["in_x"], x)[:, 0]
    Bv = L.linear(params["in_b"], x)[:, 0]
    Cv = L.linear(params["in_c"], x)[:, 0]
    dt = L.linear(params["in_dt"], x)[:, 0]
    step = lambda t, name: _conv_step(t.float(), state[name],
                                      params[name]["w"].float(),
                                      params[name]["b"].float())
    xin, cx = step(xin, "conv_x")
    Bv, cb = step(Bv, "conv_b")
    Cv, cc = step(Cv, "conv_c")
    xin, Bv, Cv = F.silu(xin), F.silu(Bv), F.silu(Cv)
    dt = F.softplus(dt.float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])                      # (H,)
    xh = xin.reshape(Bsz, H, s.head_dim)
    rep = H // s.n_groups
    Bh = Bv.reshape(Bsz, s.n_groups, s.state_dim).repeat_interleave(rep, 1)
    Ch = Cv.reshape(Bsz, s.n_groups, s.state_dim).repeat_interleave(rep, 1)
    dA = torch.exp(dt * A[None, :])                      # (B,H)
    S = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh * dt[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", S, Ch) + xh * params["D"][None, :, None]
    y = y.reshape(Bsz, d_inner).to(x.dtype)
    y = L.rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    y = L.linear(params["out"], y[:, None])
    return y, {"ssm": S, "conv_x": cx, "conv_b": cb, "conv_c": cc}
