"""Atomic, asynchronous checkpoints of torch state trees (the port of
``repro.checkpoint.checkpoint``, one process).

Layout:  <dir>/step_<N>/
            manifest.json   — tree structure, per-leaf shape and dtype name
            leaves.npz      — the leaves as numpy arrays (no pickle)

* Atomic: written to ``step_<N>.tmp``, then renamed; a reader never sees
  a partial checkpoint.
* Asynchronous: :func:`save` copies every leaf to host memory before it
  returns (so the caller may go on mutating device state, as the
  pipeline's in-place ring does), and with ``async_=True`` only the file
  IO runs on a background thread.
* NamedTuple-faithful: restored trees rebuild the registered NamedTuple
  classes (``DFAState`` and its parts come back as themselves); an
  unknown class rebuilds as a dynamic namedtuple of the same name and
  fields.
* keep-last-k garbage collection.
* bf16 leaves are stored as their int16 bits with the dtype name in the
  manifest — numpy has no bfloat16. The reference writes a msgpack
  manifest and restores bf16 through ``ml_dtypes``; this format needs
  neither, and the two packages' checkpoints are not interchangeable.

Concurrency: directory mutation (rename + GC) and reads happen under a
module lock, so overlapping async saves and a restore racing a save's GC
are serialised.
"""
from __future__ import annotations

import collections
import importlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.device import on_card_or_cpu

Tree = Any
_SEP = "/"
MANIFEST = "manifest.json"
LEAVES = "leaves.npz"

# serialises directory mutation (tmp -> final rename, GC) and reads
_IO_LOCK = threading.Lock()

# NamedTuple classes restorable by name; the port's state classes are
# found lazily, user classes through register_namedtuple
_NT_REGISTRY: Dict[str, Type] = {}
_BUILTIN_NT = (
    ("repro_torch.core.pipeline", ("DFAState", "RoutedBatch",
                                   "StepOutputs")),
    ("repro_torch.core.reporter", ("ReporterState",)),
    ("repro_torch.core.translator", ("TranslatorState",)),
    ("repro_torch.core.collector", ("CollectorState",)),
)

# torch dtypes numpy cannot hold, stored as same-width integer bits
_BITS_AS = {torch.bfloat16: torch.int16}


def register_namedtuple(cls: Type) -> Type:
    """Register a NamedTuple class so restore rebuilds it by name.
    Usable as a decorator; returns ``cls`` unchanged."""
    _NT_REGISTRY[cls.__name__] = cls
    return cls


def _resolve_namedtuple(name: str, fields: List[str]) -> Type:
    cls = _NT_REGISTRY.get(name)
    if cls is None:
        for mod, names in _BUILTIN_NT:
            if name in names:
                cls = getattr(importlib.import_module(mod), name, None)
                if cls is not None:
                    _NT_REGISTRY[name] = cls
    if cls is not None and list(getattr(cls, "_fields", ())) == list(fields):
        return cls
    # unknown class, or its fields changed since the save: a dynamic
    # namedtuple keeps attribute access working
    return collections.namedtuple(name, fields)  # type: ignore[misc]


def _flatten(tree: Tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _tree_structure(tree: Tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "cls": type(tree).__name__,
                "fields": list(tree._fields),
                "items": [_tree_structure(v) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_structure(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _rebuild(struct, leaves: Dict[str, Any], prefix="") -> Tree:
    k = struct["__kind__"]
    if k in ("list", "tuple", "namedtuple"):
        items = [_rebuild(v, leaves, f"{prefix}{i}{_SEP}")
                 for i, v in enumerate(struct["items"])]
        if k == "list":
            return items
        if k == "namedtuple":
            return _resolve_namedtuple(struct["cls"], struct["fields"])(*items)
        return tuple(items)
    if k == "dict":
        return {key: _rebuild(v, leaves, f"{prefix}{key}{_SEP}")
                for key, v in struct["items"].items()}
    if k == "none":
        return None
    return leaves[prefix[:-1]]


def _to_host(v) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name). Device tensors are copied
    synchronously; bf16 travels as its int16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype in _BITS_AS:
            t = t.view(_BITS_AS[t.dtype])
        return t.numpy().copy(), name
    a = np.array(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, name: str, device) -> torch.Tensor:
    want = getattr(torch, name)
    t = torch.from_numpy(np.array(a, copy=True))    # keeps 0-d leaves
    if want in _BITS_AS:
        t = t.view(want)
    return t.to(device)


def save(tree: Tree, directory: str, step: int, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Save a tree of tensors (and numpy arrays / scalars). Every leaf is
    on the host when this returns; with ``async_`` the file IO runs on
    the returned thread (join it), else it is done too."""
    struct = _tree_structure(tree)
    host: Dict[str, np.ndarray] = {}
    meta: Dict[str, Dict] = {}
    for k, v in _flatten(tree).items():
        arr, name = _to_host(v)
        host[k] = arr
        meta[k] = {"shape": list(arr.shape), "dtype": name}

    def write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, LEAVES),
                 **{k.replace(_SEP, "__"): v for k, v in host.items()})
        # the manifest last: list_steps counts a step once it has one
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": step, "structure": struct, "meta": meta}, f)
        with _IO_LOCK:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _gc(directory, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(directory: str, keep: int):
    # caller holds _IO_LOCK
    steps = list_steps(directory)
    for s in (steps if keep <= 0 else steps[:-keep]):
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None,
            device="cuda") -> Tuple[Tree, int]:
    """Restore the checkpoint of ``step`` (default: the newest) as a tree
    of tensors on ``device`` (the card unless the caller asks for
    ``"cpu"``). Returns (tree, step)."""
    device = on_card_or_cpu(device, "checkpoint.restore")
    with _IO_LOCK:
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {directory}")
        d = os.path.join(directory, f"step_{step}")
        with open(os.path.join(d, MANIFEST)) as f:
            man = json.load(f)
        with np.load(os.path.join(d, LEAVES), allow_pickle=False) as z:
            arrays = {k.replace("__", _SEP): z[k] for k in z.files}
    leaves = {k: _from_host(a, man["meta"][k]["dtype"], device)
              for k, a in arrays.items()}
    return _rebuild(man["structure"], leaves), step
