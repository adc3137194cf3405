"""The train step and the state layouts (the port of
``repro.launch.steps``).

The reference's sharding helpers (``train_state_shardings``,
``cache_shardings``, ``serve_param_shardings``) become
:func:`train_state_specs`, :func:`cache_specs` and
:func:`serve_param_specs`: the same partition specs over an
``EmulatedMesh``, which the dry run (``launch.dryrun``) reads for each
device's share of the state; every mesh of the port lives on one device,
so nothing is laid out by them. :func:`abstract_train_state` is the
state on ``meta`` tensors. The reference's prefill and decode step
builders are ``Model.prefill`` / ``Model.decode`` themselves (see
``launch.serve``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import param as PM
from repro_torch.models.registry import Model, decode_axes
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at

Tree = Any


def loss_and_grads(model: Model, params: Tree, batch
                   ) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradients in the parameters' dtypes) of one batch. The
    sigmoid router's ``bias`` steers only top-k's indices, which carry no
    gradient, so the loss may not reach it: it gets a zero gradient, as
    in the reference; so does an empty leaf (a stack cut to 0 layers).
    Any other leaf the loss does not reach raises."""
    leaves = adamw.leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    tracked = adamw.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = model.loss(tracked, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    stray = ["/".join(p) for p, t, g in zip(adamw.paths(params), live, grads)
             if g is None and t.numel() and p[-2:] != ("moe", "bias")]
    if stray:
        raise RuntimeError(f"the loss does not reach the parameters {stray}")
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(live, grads))
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


def make_train_step(model: Model, tcfg: TrainConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """(state, batch) -> (state, metrics); state = {"params", "opt"},
    metrics = {"loss", "gnorm", "lr"} (0-d tensors on the model's
    device). ``tcfg.grad_accum`` = a > 1 splits the batch into a
    micro-batches along its first dim, sums their f32 gradients and
    divides by a. Under ``tcfg.donate_state`` the parameters and moments
    are updated in place (the step's input state is consumed)."""

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        a = tcfg.grad_accum
        if a > 1:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            B = next(iter(batch.values())).shape[0]
            for i in range(a):
                mb = {k: v[i * (B // a):(i + 1) * (B // a)]
                      for k, v in batch.items()}
                l, g = loss_and_grads(model, params, mb)
                loss = loss + l
                grads = adamw.tree_map(lambda acc, x: acc.add_(x), grads, g)
            loss = loss / a
            grads = adamw.tree_map(lambda g: g / a, grads)
        else:
            loss, grads = loss_and_grads(model, params, batch)
        lr = lr_at(opt.step, tcfg)
        params, opt, gnorm = adamw.apply(params, grads, opt, tcfg, lr,
                                         inplace=tcfg.donate_state)
        return ({"params": params, "opt": opt},
                {"loss": loss, "gnorm": gnorm, "lr": lr})

    return step


def init_train_state(model: Model, tcfg: TrainConfig, seed=0) -> Dict:
    """Random parameters from ``seed`` (an int or a ``torch.Generator`` on
    the model's device) and zero AdamW moments in
    ``cfg.opt_state_dtype``."""
    params = model.init(seed)
    opt = adamw.init(params, tcfg, model.cfg.opt_state_dtype)
    return {"params": params, "opt": opt}


def abstract_train_state(model: Model, tcfg: TrainConfig) -> Dict:
    """The train state on ``meta`` tensors: the parameters and AdamW
    moments in ``cfg.opt_state_dtype``, no storage."""
    params = model.abstract_params()
    opt = adamw.init(params, tcfg, model.cfg.opt_state_dtype)
    return {"params": params, "opt": opt}


def train_state_specs(model: Model, tcfg: TrainConfig, mesh) -> Dict:
    """The train state's partition specs over ``mesh``: the moments laid
    out as their parameters, the step replicated."""
    specs = model.param_specs(mesh)
    return {"params": specs,
            "opt": adamw.OptState(step=(), mu=specs, nu=specs)}


def cache_specs(model: Model, mesh, batch: int, seq: int) -> Tree:
    """The decode cache's specs, consistent with ``decode_axes``: the
    batch over its batch axes, the cached sequence over the rest."""
    baxes, saxes = decode_axes(mesh, batch, seq)
    rules = PM.default_rules(mesh).replace(batch=baxes, kv_seq=saxes)
    return PM.partition_specs(model.cache_descs(batch, seq), rules)


def serve_param_specs(model: Model, mesh, batch: int) -> Tree:
    """The decode-time parameter layout: MoE experts over the wide EP
    axes of ``moe.decode_ep_axes``, so no per-layer FSDP weight gathers
    (the reference's ``serve_param_shardings``)."""
    from repro_torch.models import moe as M
    rules = PM.default_rules(mesh)
    if model.cfg.moe is not None:
        rules = rules.replace(
            experts=M.decode_ep_axes(model.cfg, mesh, batch))
    return model.param_specs(mesh, rules)
