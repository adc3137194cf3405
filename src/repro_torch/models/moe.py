"""Mixture-of-Experts FFN on one device (the port of ``repro.models.moe``).

Routing follows the config: softmax or sigmoid scores (deepseek-v3, whose
per-expert ``bias`` steers the selection only), top-k, renormalised, the
routed scaling factor; shared experts bypass routing. Dispatch is the
reference's capacity-bounded gather: the (token, expert) pairs are ranked
by expert with a STABLE sort, each expert keeps its first ``C`` pairs in
a (E, C, d) buffer, the experts run as batched products, and each slot's
weighted output is added back to its token. A pair past its expert's
capacity is dropped, as in the reference; an unstable sort would drop
other pairs.

The reference runs :func:`_expert_gather_compute` on each expert-parallel
rank's share of the experts (``E_loc`` of them from ``my_first``) and sums
the shares with a psum; on one device the share is every expert and the
psum is the identity. :func:`decode_ep_axes` picks the mesh axes of that
sharding, as the reference's does, for the dry run's serving layout
(``launch.steps.serve_param_specs``). The expert products are plain
``torch.einsum``: the reference computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamDesc

Tree = Any


def moe_descs(cfg: ModelConfig) -> Tree:
    m = cfg.moe
    dt = cfg.param_dtype
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    t = {"router": ParamDesc((d, E), "float32", ("embed", None)),
         "gate": ParamDesc((E, d, f), dt, ("experts", "embed", None)),
         "up": ParamDesc((E, d, f), dt, ("experts", "embed", None)),
         "down": ParamDesc((E, f, d), dt, ("experts", None, "embed"))}
    if m.score_func == "sigmoid":
        t["bias"] = ParamDesc((E,), "float32", (None,), init="zeros")
    if m.num_shared_experts:
        f_sh = m.d_ff_shared * m.num_shared_experts
        t["shared"] = {"gate": L.linear_descs(d, f_sh, dt, in_axis="embed",
                                              out_axis="model"),
                       "up": L.linear_descs(d, f_sh, dt, in_axis="embed",
                                            out_axis="model"),
                       "down": L.linear_descs(f_sh, d, dt, in_axis="model",
                                              out_axis="embed")}
    return t


def decode_ep_axes(cfg: ModelConfig, mesh, tokens: int) -> Tuple[str, ...]:
    """Expert-parallel axes of the serving layout over ``mesh`` (an
    ``EmulatedMesh``): EP widens over ("model", "data", "pod") while the
    expert count divides and the replicated token activations stay
    small (decode: ~128 tokens), else ("model",)."""
    sizes = mesh.shape
    axes = []
    prod = 1
    for ax in ("model", "data", "pod"):
        if ax in sizes and cfg.moe.num_experts % (prod * sizes[ax]) == 0:
            axes.append(ax)
            prod *= sizes[ax]
    if tokens * cfg.d_model * 2 > 64 * 2**20:
        return ("model",)
    return tuple(axes) if axes else ("model",)


def route(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (weights (T, k) f32, experts (T, k) int64)."""
    m = cfg.moe
    logits = x.float() @ params["router"]                     # (T, E)
    if m.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
        # the bias steers the selection; the weights are the scores'
        _, idx = torch.topk(scores + params["bias"][None, :], m.top_k, dim=-1)
        w = torch.gather(scores, -1, idx)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        w = w * m.routed_scaling_factor
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, m.top_k, dim=-1)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return w, idx


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens on one device:
    max(1, ceil(tokens * top_k * capacity_factor / E)), the reference's C
    on a (1, 1) mesh."""
    m = cfg.moe
    return max(1, int(math.ceil(tokens * m.top_k * m.capacity_factor
                                / m.num_experts)))


def drops_of(run: Callable[[], Any]) -> List[Tuple[int, int]]:
    """Runs ``run()`` (a prefill, or a loss) and returns (pairs dropped by
    capacity, pairs routed) of each expert layer it went through, in call
    order: :func:`route` on the layer's input, and per expert max(0,
    pairs - C). The layers' outputs are unchanged."""
    global moe_ffn
    original, counts = moe_ffn, []

    def counted(params, x, cfg):
        B, S, d = x.shape
        with torch.no_grad():
            _, idx = route(params, x.reshape(B * S, d), cfg)
            per_expert = torch.bincount(idx.reshape(-1),
                                        minlength=cfg.moe.num_experts)
            C = capacity(cfg, B * S)
            counts.append((int((per_expert - C).clamp(min=0).sum()),
                           idx.numel()))
        return original(params, x, cfg)
    moe_ffn = counted
    try:
        run()
    finally:
        moe_ffn = original
    return counts


def _expert_gather_compute(x_flat, w_pair, e_pair, params_loc, E_loc: int,
                           C: int, my_first: int) -> torch.Tensor:
    """Capacity-bounded dispatch to the experts [my_first, my_first +
    E_loc), whose weights ``params_loc`` holds.

    x_flat: (T, d) all tokens; e_pair / w_pair: (T*k,) routing, pair p
    belonging to token p // k. Returns the (T, d) sum of this share's
    weighted expert outputs; a token none of whose pairs landed here gets
    0."""
    T, d = x_flat.shape
    n_pairs = e_pair.shape[0]
    k = n_pairs // T
    dev = x_flat.device
    le = e_pair - my_first
    valid = (le >= 0) & (le < E_loc)
    key = torch.where(valid, le, E_loc)
    order = torch.argsort(key, stable=True)                   # (pairs,)
    sorted_le = key[order]
    start = torch.searchsorted(sorted_le, torch.arange(E_loc, device=dev))
    rank_in_e = (torch.arange(n_pairs, device=dev)
                 - start[sorted_le.clamp(0, E_loc - 1)])
    ok = (sorted_le < E_loc) & (rank_in_e < C)
    slot = torch.where(ok, sorted_le * C + rank_in_e, E_loc * C)
    pair_tok = order // k
    # slot-space bookkeeping, (E_loc*C + 1,): the last slot takes every
    # dropped or foreign pair, and all of those write the same values
    buf_tok = torch.full((E_loc * C + 1,), T, dtype=torch.int64, device=dev)
    buf_tok[slot] = torch.where(ok, pair_tok, T)
    w_slot = torch.zeros(E_loc * C + 1, dtype=torch.float32, device=dev)
    w_slot[slot] = torch.where(ok, w_pair[order].float(), 0.0)
    x_pad = torch.cat([x_flat, x_flat.new_zeros(1, d)], 0)
    buf = x_pad[buf_tok[:-1]].reshape(E_loc, C, d)
    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, params_loc["gate"]))
         * torch.einsum("ecd,edf->ecf", buf, params_loc["up"]))
    out = torch.einsum("ecf,efd->ecd", h, params_loc["down"])
    rows = out.reshape(E_loc * C, d) * w_slot[:-1, None].to(out.dtype)
    contrib = torch.zeros(T + 1, d, dtype=out.dtype, device=dev)
    contrib.index_add_(0, buf_tok[:-1], rows)
    return contrib[:T]


def moe_ffn(params, x, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the routed experts, every one on this
    device with C = :func:`capacity` of the B*S tokens (1 at decode with
    B = 4 under deepseek-v3's config), plus the shared expert."""
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    w, idx = route(params, xf, cfg)
    y = _expert_gather_compute(xf, w.reshape(-1), idx.reshape(-1), params,
                               m.num_experts, capacity(cfg, B * S), 0)
    y = y.reshape(x.shape).to(x.dtype)
    if m.num_shared_experts:
        y = y + L.ffn(params["shared"], x)
    return y


def load_balance_loss(params, x, cfg: ModelConfig) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style) over the tokens of x:
    E * sum_e (share of tokens whose first choice is e) * (mean router
    probability of e), f32 0-d. The reference defines it for training and
    does not call it."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xf @ params["router"], dim=-1)      # (T, E)
    _, idx = torch.topk(probs, m.top_k, dim=-1)
    onehot = F.one_hot(idx[..., 0], m.num_experts).float()
    return m.num_experts * torch.sum(onehot.mean(0) * probs.mean(0))
