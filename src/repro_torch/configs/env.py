"""The single registry of every ``REPRO_*`` environment override the port
reads (the port of ``repro.configs.env``).

Every override is declared here once, with one parsing rule per kind and
one fail-loud contract: a malformed value raises ``ValueError`` naming
the variable and what it accepts. It is never silently ignored, because
a typo'd override that loses quietly looks the same as one that worked.
The parsing rules and error texts are the reference's, so the same raw
value gives the same result, or raises, in both packages.

Kinds:

``choice``
    One of a fixed set of strings. Unset, ``""`` and ``"auto"`` all mean
    "defer to the next stage of the precedence ladder"
    (``repro_torch.kernels.dispatch``); anything else must be a
    registered choice. A value in ``tpu_only`` names TPU machinery of the
    reference (a Pallas backend, a VMEM variant) and raises with that
    reason.
``flag``
    Boolean. Unset/``""``/``"0"``/``"false"``/``"no"``/``"off"`` are
    false; ``"1"``/``"true"``/``"yes"``/``"on"`` are true (case
    insensitive). Anything else raises.
``str``
    A free-form string (a filesystem path, typically). Unset/``""`` ->
    None; the raw value otherwise, not lowercased. The consumer
    validates what it points at, fail-loud.

The overrides (:func:`env_table` renders them):

=======================  ======  =========  ================================
variable                 kind    values     consumed by
=======================  ======  =========  ================================
REPRO_KERNEL_BACKEND     choice  cuda|ref   kernels.dispatch.resolve_backend
                                            (beats DFAConfig.kernel_backend,
                                            loses to an explicit
                                            ``backend=``); pallas and
                                            interpret raise
REPRO_GATHER_VARIANT     choice  (auto)     kernels.dispatch: full and hbm
                                            raise (one CUDA kernel)
REPRO_INGEST_VARIANT     choice  (auto)     kernels.dispatch: block and hbm
                                            raise (one CUDA kernel)
REPRO_WIRE_FORMAT        choice  v1|v2      core.wire (beats
                                            DFAConfig.wire_format)
REPRO_TUNING_REGISTRY    str     path       kernels.tuning (beats
                                            DFAConfig.tuning_registry)
=======================  ======  =========  ================================

The reference registers two more, whose consumers lie outside its
package: ``REPRO_BENCH_TINY`` (read by ``benchmarks/``, which the port
does not have yet) and ``REPRO_REGEN_GOLDENS`` (read by the reference's
golden test under ``tests/``). Nothing in this package reads either, so
neither is registered here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")


@dataclass(frozen=True)
class EnvSpec:
    """One registered override: its name, kind and legal values."""

    name: str
    kind: str                         # "choice" | "flag" | "str"
    choices: Tuple[str, ...] = ()     # kind == "choice" only
    description: str = ""
    consumer: str = ""                # module that reads it
    # the reference's values for TPU machinery the port has no part of
    tpu_only: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in ("choice", "flag", "str"):
            raise ValueError(f"unknown env kind {self.kind!r}")
        if self.kind == "choice" and not (self.choices or self.tpu_only):
            raise ValueError(f"{self.name}: choice spec needs choices")


_REGISTRY: Dict[str, EnvSpec] = {}


def register(spec: EnvSpec) -> EnvSpec:
    """Register (or re-register, for tests) one override."""
    _REGISTRY[spec.name] = spec
    return spec


def registered() -> Dict[str, EnvSpec]:
    return dict(_REGISTRY)


def spec(name: str) -> EnvSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unregistered env override {name!r}; registered: "
            f"{sorted(_REGISTRY)} (declare it in repro_torch.configs.env)")
    return _REGISTRY[name]


def read_choice(name: str) -> Optional[str]:
    """The validated value of a choice var, or ``None`` when it defers.

    Unset / ``""`` / ``"auto"`` -> None (the precedence ladder moves on);
    a registered choice -> that choice; anything else raises listing the
    registered values, even when a stronger setting (an explicit
    ``backend=`` argument) would win, so a typo can never lose silently.
    """
    s = spec(name)
    if s.kind != "choice":
        raise ValueError(f"{name} is a {s.kind} var, not a choice")
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("", "auto"):
        return None
    if raw in s.tpu_only:
        raise ValueError(
            f"value {raw!r} from env var {name} names TPU machinery of the "
            f"JAX package; the PyTorch port takes {list(s.choices)} "
            "(or 'auto')")
    if raw not in s.choices:
        raise ValueError(
            f"unknown value {raw!r} from env var {name}; registered: "
            f"{list(s.choices)} (or 'auto')")
    return raw


def read_flag(name: str) -> bool:
    """The validated value of a flag var (unset -> False; junk raises)."""
    s = spec(name)
    if s.kind != "flag":
        raise ValueError(f"{name} is a {s.kind} var, not a flag")
    raw = os.environ.get(name, "").strip().lower()
    if raw in _FALSE:
        return False
    if raw in _TRUE:
        return True
    raise ValueError(
        f"unknown value {raw!r} from env var {name}; a flag accepts "
        f"{list(_TRUE)} / {list(_FALSE)}")


def read_str(name: str) -> Optional[str]:
    """The raw value of a string var, or ``None`` when unset/empty (no
    lowercasing: paths are case-sensitive)."""
    s = spec(name)
    if s.kind != "str":
        raise ValueError(f"{name} is a {s.kind} var, not a str")
    raw = os.environ.get(name, "").strip()
    return raw or None


def env_table() -> str:
    """Markdown table of every registered override (for README/docs)."""
    lines = ["| variable | kind | values | consumed by |",
             "|---|---|---|---|"]
    for name in sorted(_REGISTRY):
        s = _REGISTRY[name]
        vals = ("\\|".join(s.choices or ("auto",)) if s.kind == "choice"
                else "0/1" if s.kind == "flag" else "path")
        if s.tpu_only:
            vals += f" (refused: {', '.join(s.tpu_only)})"
        lines.append(f"| `{name}` | {s.kind} | {vals} | {s.consumer}: "
                     f"{s.description} |")
    return "\n".join(lines)


# -- the overrides the port reads --------------------------------------------

KERNEL_BACKEND = register(EnvSpec(
    "REPRO_KERNEL_BACKEND", "choice", ("cuda", "ref"),
    description="kernel backend (beats DFAConfig.kernel_backend, loses "
                "to an explicit backend= argument)",
    consumer="repro_torch.kernels.dispatch",
    tpu_only=("pallas", "interpret")))

GATHER_VARIANT = register(EnvSpec(
    "REPRO_GATHER_VARIANT", "choice",
    description="gather_enrich memory strategy of the TPU kernels; the "
                "port has one CUDA kernel, so only auto is accepted",
    consumer="repro_torch.kernels.dispatch",
    tpu_only=("full", "hbm")))

INGEST_VARIANT = register(EnvSpec(
    "REPRO_INGEST_VARIANT", "choice",
    description="ingest_update event-stream strategy of the TPU kernels; "
                "the port has one CUDA kernel, so only auto is accepted",
    consumer="repro_torch.kernels.dispatch",
    tpu_only=("block", "hbm")))

TUNING_REGISTRY = register(EnvSpec(
    "REPRO_TUNING_REGISTRY", "str",
    description="path to a tuned-config registry JSON (kernels.tuning; "
                "chip_smoke.py's [tune] writes one; beats "
                "DFAConfig.tuning_registry)",
    consumer="repro_torch.kernels.tuning"))

WIRE_FORMAT = register(EnvSpec(
    "REPRO_WIRE_FORMAT", "choice", ("v1", "v2"),
    description="active wire schema (v1 = the paper's 8-bit "
                "reporter_id/seq layout, v2 = the widened u16 layout; "
                "beats DFAConfig.wire_format)",
    consumer="repro_torch.core.wire"))
