"""The train step (the port of ``repro.launch.steps``, training part).

The reference's sharding helpers (``train_state_shardings``,
``cache_shardings``, ``serve_param_shardings``) lay state out over a
mesh and have nothing to do on one device; its prefill and decode step
builders are ``Model.prefill`` / ``Model.decode`` themselves (see
``launch.serve``). Neither is ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.registry import Model
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
