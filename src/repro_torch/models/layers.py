"""Shared building blocks: norms, rotary embeddings, gated FFNs, embeddings
(the port of ``repro.models.layers``).

All layers are functions over explicit parameter dicts; each has a
``*_descs`` function returning the matching ParamDesc tree. Projection
matrices are 2-D ``(d_in, d_out)`` as in the reference, so ``x @ w`` is
the same product. The reference's mesh constraints (``seq_shard``,
``head_shard``) have nothing to do on one device, and neither has the
vocab-sharded branch of its ``chunked_ce_loss``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDesc, tree_map_descs

Tree = Any


def stack_descs(descs: Tree, n: int) -> Tree:
    """Prepend an unsharded layer dimension to every leaf (the reference
    scans over it; the port loops)."""
    return tree_map_descs(
        lambda p, d: dataclasses.replace(
            d, shape=(n,) + d.shape,
            axes=(None,) + tuple(d.axes or (None,) * len(d.shape))), descs)


# ---------------------------------------------------------------- norms ----

def rms_norm_descs(dim: int, dtype: str) -> Tree:
    return {"scale": ParamDesc((dim,), dtype, (None,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def layer_norm_descs(dim: int, dtype: str) -> Tree:
    return {"scale": ParamDesc((dim,), dtype, (None,), init="ones"),
            "bias": ParamDesc((dim,), dtype, (None,), init="zeros")}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance over the last axis, scale and bias, all in f32;
    the result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dtype)


# --------------------------------------------------------------- linear ----

def linear_descs(d_in: int, d_out: int, dtype: str, *, bias: bool = False,
                 in_axis: Optional[str] = None,
                 out_axis: Optional[str] = None) -> Tree:
    t = {"w": ParamDesc((d_in, d_out), dtype, (in_axis, out_axis))}
    if bias:
        t["b"] = ParamDesc((d_out,), dtype, (out_axis,), init="zeros")
    return t


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# --------------------------------------------------------------- rotary ----

def rotary(positions: torch.Tensor, head_dim: int,
           theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables for the given positions; positions: (...,)"""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python float base: a device tensor made from it would be a host
    # copy that waits for the card on every call
    freqs = 1.0 / (theta ** expo)
    ang = positions.float()[..., None] * freqs                # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable (..., S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:                       # (S, half) -> (S, 1, half)
        cos, sin = cos[:, None, :], sin[:, None, :]
    else:                                   # (..., S, half)
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ FFN ----

def ffn_descs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Tree:
    """A gated (or, under gelu, plain) FFN of width ``d_ff`` (default
    ``cfg.d_ff``)."""
    d_ff, dt = d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.act == "gelu":                   # non-gated MLP with bias
        return {"up": linear_descs(cfg.d_model, d_ff, dt, bias=True,
                                   in_axis="embed", out_axis="model"),
                "down": linear_descs(d_ff, cfg.d_model, dt, bias=True,
                                     in_axis="model", out_axis="embed")}
    return {"gate": linear_descs(cfg.d_model, d_ff, dt,
                                 in_axis="embed", out_axis="model"),
            "up": linear_descs(cfg.d_model, d_ff, dt,
                               in_axis="embed", out_axis="model"),
            "down": linear_descs(d_ff, cfg.d_model, dt,
                                 in_axis="model", out_axis="embed")}


def ffn(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if "gate" in params:
        h = F.silu(linear(params["gate"], x)) * linear(params["up"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(params["up"], x), approximate="tanh")
    return linear(params["down"], h)


# ------------------------------------------------------------ embedding ----

def embed_descs(cfg: ModelConfig) -> Tree:
    t = {"tok": ParamDesc((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                          ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        t["unembed"] = ParamDesc((cfg.d_model, cfg.vocab_size),
                                 cfg.param_dtype, ("embed", "vocab"),
                                 init="normal")
    return t


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def logits_fn(embed_params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    w = embed_params["tok"].T if tie else embed_params["unembed"]
    return x @ w


# --------------------------------------------------- chunked cross entropy ----

def chunked_ce_loss(embed_params, x: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, tie: bool, chunk: int
                    ) -> torch.Tensor:
    """Mean cross-entropy over the vocab without the full (B, S, V) logits.

    x: (B, S, d) final hidden; targets: (B, S) int; mask: (B, S) {0, 1}.
    Walks the sequence in chunks of ``chunk`` positions (the last one
    ragged); each chunk's logits are made in f32 from ``logits_fn``.
    Returns ``sum((lse - picked) * mask) / max(sum(mask), 1)``."""
    S = x.shape[1]
    chunk = min(chunk, S)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        lg = logits_fn(embed_params, x[:, lo:hi], tie).float()
        picked = torch.gather(lg, -1, targets[:, lo:hi, None])[..., 0]
        lse = torch.logsumexp(lg, dim=-1)
        m = mask[:, lo:hi].float()
        tot = tot + ((lse - picked) * m).sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
