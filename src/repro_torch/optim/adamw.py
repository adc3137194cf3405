"""AdamW with decoupled weight decay, global-norm clipping and a chosen
optimizer-state dtype (the port of ``repro.optim.adamw``).

Trees are nested dicts of tensors. The arithmetic is the reference's,
in f32 whatever the storage dtypes: clipped gradients are rounded back
to the gradient's dtype (as ``clip_by_global_norm`` returns them), the
moments are updated in f32 and stored in ``state_dtype``, the bias
corrections use the post-increment step, and the decay is applied to
the f32 parameter. Plain elementwise PyTorch: the reference computes
this outside any Pallas kernel.

The norm and the update run in slices of at most ``CHUNK`` elements, so
their f32 temporaries stay small next to a full-width stacked leaf (a
(40, 2048, 8192) FFN matrix is 2.7 GB in f32); slicing changes no value
of the update (the norm's sum is taken in another order). With
``inplace=True`` the new parameters and moments are written into the
tensors passed in (the reference donates them to ``jit``).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from repro_torch.checkpoint.checkpoint import register_namedtuple
from repro_torch.configs.base import TrainConfig
from repro_torch.models.param import torch_dtype

Tree = Any
CHUNK = 1 << 24          # elements per slice of the update


@register_namedtuple
class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32: updates applied so far
    mu: Tree
    nu: Tree


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """The key paths of a nested dict's leaves, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, prefix + (k,))]
    return [prefix]


def init(params: Tree, cfg: TrainConfig, state_dtype: str = "float32"
         ) -> OptState:
    dt = torch_dtype(state_dtype)
    first = leaves(params)[0]
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    mu=tree_map(z, params), nu=tree_map(z, params))


def _slices(n: int):
    for lo in range(0, n, CHUNK):
        yield slice(lo, min(lo + CHUNK, n))


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum of every gradient element's square, in f32 (in
    slices, as the update)."""
    sq = sum(g.reshape(-1)[s].float().square().sum()
             for g in leaves(grads) for s in _slices(g.numel()))
    return torch.sqrt(sq)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to at most ``max_norm`` and rounded back to their
    dtypes, the global norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply(params: Tree, grads: Tree, opt: OptState, cfg: TrainConfig,
          lr, inplace: bool = False) -> Tuple[Tree, OptState, torch.Tensor]:
    """One AdamW update. Returns (params, opt state, gradient norm before
    clipping); ``lr`` is a float or a 0-d tensor. ``inplace``: write the
    results into ``params``, ``opt.mu`` and ``opt.nu`` (which are then the
    returned tensors) instead of new tensors."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, cfg.grad_clip)
        step = opt.step + 1
        b1, b2 = cfg.beta1, cfg.beta2
        stepf = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=stepf.device), stepf)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

        def upd(p, g, m, v):
            outs = ((p, m, v) if inplace else
                    (torch.empty_like(p), torch.empty_like(m),
                     torch.empty_like(v)))
            flat = [t.reshape(-1) for t in (p, g, m, v) + outs]
            fp, fg, fm, fv, op, om, ov = flat
            for s in _slices(fp.numel()):
                g32 = (fg[s].float() * scale).to(g.dtype).float()
                m32 = fm[s].float() * b1 + (1 - b1) * g32
                v32 = fv[s].float() * b2 + (1 - b2) * g32 * g32
                mh = m32 / c1
                vh = v32 / c2
                p32 = fp[s].float()
                delta = mh / (torch.sqrt(vh) + cfg.eps) \
                    + cfg.weight_decay * p32
                op[s] = (p32 - lr * delta).to(p.dtype)
                om[s] = m32.to(m.dtype)
                ov[s] = v32.to(v.dtype)
            return outs

        out = tree_map(upd, params, grads, opt.mu, opt.nu)
        p, m, v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return p, OptState(step, m, v), gnorm
