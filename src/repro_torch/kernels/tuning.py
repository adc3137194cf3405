"""Measurement-driven tuned-config registry (the port of
``repro.kernels.tuning``).

A tuning run times a kernel knob at the shapes a path gives it and
persists the winners, so ``kernels.dispatch.resolve_*`` consults
measurements before falling back to the configuration's static value.
``chip_smoke.py``'s ``[tune]`` phase times K1's event tile at the main
path's event count on the card and writes such a file.

File format (``schema: "repro-tuning-v1"``, the reference's; a file
written by either package loads in the other, and both write the same
bytes for the same entries)::

    {"schema": "repro-tuning-v1",
     "entries": [{"knob": "ingest_update.event_tile",
                  "backend": "cuda",
                  "key": [1048576],
                  "value": 128,
                  "us_per_call": 27.1,
                  "source": "chip_smoke"}, ...]}

Registered knobs and their shape keys (the reference's, so a file loads
in both packages):

* ``ingest_update.event_tile``  — key ``[events]``, value int tile. The
  port consults it: ``dispatch.resolve_event_tile`` under the name of
  what runs the fused ingest's segment sums, ``"cuda"`` for K1 on the
  card and ``"ref"`` for its plain version.
* ``gather_enrich.variant``, ``gather_enrich.report_tile``,
  ``ingest_update.variant`` — the TPU kernels' VMEM strategies and
  report tile. They load and validate, but the port never consults
  them: its CUDA kernels have one variant each, and K3's blocks are
  planned per warp (``dfa::plan``), not by a report tile.

Lookups are exact-match on ``(knob, backend, key)``: a tuned winner for
one shape says nothing about another, so there is no nearest-shape
interpolation. ``record`` keeps the fastest entry per key.

Precedence: arming a registry is an explicit opt-in
(``REPRO_TUNING_REGISTRY`` > ``DFAConfig.tuning_registry``); a tuned
value for the exact shape beats the configuration's default, and a
malformed file or unknown knob fails loud at first lookup rather than
silently falling back.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import env as ENV

SCHEMA = "repro-tuning-v1"
KNOBS = ("gather_enrich.variant", "gather_enrich.report_tile",
         "ingest_update.variant", "ingest_update.event_tile")

_Key = Tuple[str, str, Tuple[int, ...]]


class TuningRegistry:
    """In-memory view of one tuned-config file (load/record/save)."""

    def __init__(self) -> None:
        self.entries: Dict[_Key, Dict[str, Any]] = {}

    @staticmethod
    def _key(knob: str, backend: str, key: Sequence[int]) -> _Key:
        if knob not in KNOBS:
            raise ValueError(
                f"unknown tuning knob {knob!r}; registered: {list(KNOBS)}")
        return (knob, str(backend), tuple(int(k) for k in key))

    def record(self, knob: str, backend: str, key: Sequence[int],
               value: Any, us_per_call: float, source: str = "") -> bool:
        """Insert a measured winner; on a key collision the FASTER entry
        wins (so re-running a sweep can only improve the registry).
        Returns whether the entry was stored."""
        if not isinstance(value, (str, int)):
            raise TypeError(
                f"tuned value must be str or int, got {type(value)}")
        k = self._key(knob, backend, key)
        old = self.entries.get(k)
        if old is not None and old["us_per_call"] <= float(us_per_call):
            return False
        self.entries[k] = {"value": value,
                           "us_per_call": float(us_per_call),
                           "source": str(source)}
        return True

    def lookup(self, knob: str, backend: str,
               key: Sequence[int]) -> Optional[Any]:
        """The tuned value for an exact (knob, backend, key) match, or
        None (no measurement for this shape — heuristic decides)."""
        e = self.entries.get(self._key(knob, backend, key))
        return None if e is None else e["value"]

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "TuningRegistry":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"{path}: schema {doc.get('schema')!r} is not {SCHEMA!r} "
                "— refusing to guess at an unknown tuning layout")
        reg = cls()
        for i, e in enumerate(doc.get("entries", [])):
            try:
                reg.record(e["knob"], e["backend"], e["key"], e["value"],
                           e["us_per_call"], e.get("source", ""))
            except (KeyError, TypeError, ValueError) as err:
                raise ValueError(
                    f"{path}: bad tuning entry #{i}: {err}") from err
        return reg

    def save(self, path: str) -> None:
        rows: List[Dict[str, Any]] = []
        for (knob, backend, key), e in sorted(self.entries.items()):
            rows.append({"knob": knob, "backend": backend,
                         "key": list(key), **e})
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA, "entries": rows}, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)


# -- cached file access (dispatch consults per kernel call) ----------------

_lock = threading.Lock()
_cache: Dict[str, Tuple[float, TuningRegistry]] = {}


def load_cached(path: str) -> TuningRegistry:
    """mtime-checked registry cache: repeated dispatch consults cost a
    stat, not a parse, and an updated file is picked up without a
    process restart."""
    mtime = os.stat(path).st_mtime
    with _lock:
        hit = _cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        reg = TuningRegistry.load(path)
        _cache[path] = (mtime, reg)
        return reg


def resolve_path(cfg) -> Optional[str]:
    """The armed registry path: ``REPRO_TUNING_REGISTRY`` env var >
    ``DFAConfig.tuning_registry`` > None (registry off)."""
    env = ENV.read_str(ENV.TUNING_REGISTRY.name)
    if env is not None:
        return env
    p = getattr(cfg, "tuning_registry", "") if cfg is not None else ""
    return p or None


def lookup_value(cfg, knob: str, backend: str,
                 key: Sequence[int]) -> Optional[Any]:
    """One-call consult for dispatch: resolve the armed path (None =
    registry off) and look up the exact (knob, backend, key). A path
    that is armed but unreadable/malformed raises — an operator who
    pointed at a registry wants to know it is not being used."""
    path = resolve_path(cfg)
    if path is None:
        return None
    return load_cached(path).lookup(knob, backend, key)
