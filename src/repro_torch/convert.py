"""State and weights across the two packages, as numpy.

``state_from_numpy`` takes the reference's ``DFAState`` with its leaves
as numpy arrays (``uint32`` / ``bool``) in its global layout — tables
stacked per shard or per port, scalar counters as (n_shards,) /
(total_ports,) vectors — as any object with ``reporter`` / ``translator``
/ ``collector`` attributes that carry the reference's field names, and
builds the port's state on a device; the port keeps the same layout, so
no leaf is reshaped. ``state_to_numpy`` is the inverse, in the
reference's dtypes and shapes, so the two can be compared leaf by leaf.
``head_params_from_numpy`` loads the reference head's ``{"w", "b"}`` / ``{"w1", "b1", "w2", "b2"}``
into a :class:`~repro_torch.models.flow_head.FlowHead`.
``lm_params_from_numpy`` builds the port's language-model parameters from
the reference's materialised ones (``Model.init``), as numpy, for any
family ``Model`` runs.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import u32 as U
from repro_torch.core.collector import CollectorState
from repro_torch.core.pipeline import DFAState
from repro_torch.core.reporter import ReporterState
from repro_torch.core.translator import TranslatorState
from repro_torch.device import on_card_or_cpu
from repro_torch.models import registry
from repro_torch.models.param import ParamDesc, torch_dtype

_GROUPS = (("reporter", ReporterState), ("translator", TranslatorState),
           ("collector", CollectorState))


def _leaf_in(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return U.from_numpy(a, device)


def _leaf_out(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bool:
        return t.detach().cpu().numpy()
    return U.to_numpy(t)


def state_from_numpy(state, device="cuda") -> DFAState:
    """Reference state (numpy leaves) -> the port's DFAState
    on ``device`` (the card unless the caller asks for ``"cpu"``)."""
    device = on_card_or_cpu(device, "state_from_numpy")
    parts = []
    for group, cls in _GROUPS:
        src = getattr(state, group)
        parts.append(cls(*(_leaf_in(getattr(src, f), device)
                           for f in cls._fields)))
    return DFAState(*parts)


def state_to_numpy(state: DFAState) -> DFAState:
    """The port's state -> the same NamedTuples holding numpy leaves in the
    reference's dtypes and shapes."""
    return DFAState(*(cls(*(_leaf_out(getattr(getattr(state, group), f))
                            for f in cls._fields))
                      for group, cls in _GROUPS))


def head_params_from_numpy(head: torch.nn.Module,
                           params: Mapping[str, np.ndarray]) -> None:
    """Copy reference head parameters (numpy, (in, out) layout) into
    ``head`` in place; the names must match the head's kind exactly."""
    own = dict(head.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"head parameters {sorted(own)} do not match the "
                         f"given {sorted(params)}")
    with torch.no_grad():
        for name, p in own.items():
            src = torch.from_numpy(np.array(params[name], np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)


def lm_params_from_numpy(tree: Mapping[str, Any], cfg, device="cuda"):
    """The reference's model parameters (nested dicts of numpy arrays,
    bf16 as ml_dtypes ``bfloat16``) -> the port's, in the dtypes of the
    family's descriptors (``models.registry.param_descs(cfg)``: the dense
    and moe families' or the hybrid's, whose stacked trunk and shared
    blocks cross whole). bf16 crosses through f32, which holds it
    exactly. Raises on a missing or extra leaf or a shape that differs.
    The parameters land on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    device = on_card_or_cpu(device, "lm_params_from_numpy")

    def rec(descs, node, path):
        if isinstance(descs, ParamDesc):
            a = np.asarray(node)
            if tuple(a.shape) != tuple(descs.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)} != "
                                 f"{tuple(descs.shape)}")
            t = torch.from_numpy(np.array(a, np.float32))
            return t.to(device=device, dtype=torch_dtype(descs.dtype))
        if not isinstance(node, Mapping):
            raise ValueError(f"{path}: expected a dict, got {type(node)}")
        if set(node) != set(descs):
            raise ValueError(f"{path}: leaves {sorted(node)} != "
                             f"{sorted(descs)}")
        return {k: rec(descs[k], node[k], f"{path}/{k}") for k in descs}
    return rec(registry.param_descs(cfg), tree, "params")
