"""The port's ``REPRO_*`` registry (``repro_torch.configs.env``) against
the reference's (``repro.configs.env``).

The same raw values give the same result, or both raise with the same
text, under each parsing rule; the overrides both packages read behave
alike; the port refuses the reference's TPU values (Pallas backends,
VMEM variants) where the reference accepts them; the backend precedence
is the reference's (argument > env > config > auto); ``core.wire``,
``DFASystem`` and ``Model`` read through the registry.
"""
import dataclasses

import pytest

from repro.configs import env as JENV
from repro.kernels import dispatch as JDISPATCH
from repro_torch.configs import REDUCED, get_config
from repro_torch.configs import env as ENV
from repro_torch.core import wire as WIRE
from repro_torch.core.pipeline import DFASystem
from repro_torch.kernels import dispatch
from repro_torch.models.registry import Model

RAW = [None, "", "  ", "auto", "AUTO", " a ", "B", "c", "1", "0", "true",
       "Yes", "off", "NO", "on", "junk", "/Some/Path.json "]
TEST_VARS = {"choice": dict(choices=("a", "b")), "flag": {}, "str": {}}


def _outcome(fn, name):
    try:
        return ("ok", fn(name))
    except (ValueError, KeyError) as e:
        return ("raises", type(e).__name__, str(e))


def _read(module, kind):
    return {"choice": module.read_choice, "flag": module.read_flag,
            "str": module.read_str}[kind]


@pytest.fixture()
def test_specs():
    """One test override of each kind, registered in both packages."""
    names = {}
    for kind, kw in TEST_VARS.items():
        name = f"REPRO_TEST_ENV_{kind.upper()}"
        JENV.register(JENV.EnvSpec(name, kind, **kw))
        ENV.register(ENV.EnvSpec(name, kind, **kw))
        names[kind] = name
    yield names
    for name in names.values():
        JENV._REGISTRY.pop(name, None)
        ENV._REGISTRY.pop(name, None)


@pytest.mark.parametrize("kind", sorted(TEST_VARS))
def test_parsing_rules_match_reference(kind, test_specs, monkeypatch):
    """Every raw value: the same value or the same error, per kind; and
    reading a var as another kind raises in both."""
    name = test_specs[kind]
    for raw in RAW:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert (_outcome(_read(ENV, kind), name)
                == _outcome(_read(JENV, kind), name)), (kind, raw)
        for other in TEST_VARS:
            if other != kind:
                assert _outcome(_read(ENV, other), name)[0] == "raises"


def test_shared_overrides_match_reference(monkeypatch):
    """REPRO_WIRE_FORMAT and REPRO_TUNING_REGISTRY parse alike in both
    packages; REPRO_KERNEL_BACKEND alike where both accept the value. The
    port refuses the reference's TPU values: pallas / interpret, and any
    VMEM variant."""
    for name in ("REPRO_WIRE_FORMAT", "REPRO_TUNING_REGISTRY"):
        kind = ENV.spec(name).kind
        assert kind == JENV.spec(name).kind
        for raw in RAW + ["v1", "V2 ", "v3"]:
            monkeypatch.setenv(name, raw or "")
            assert (_outcome(_read(ENV, kind), name)
                    == _outcome(_read(JENV, kind), name)), (name, raw)
    name = "REPRO_KERNEL_BACKEND"
    for raw in ("", "auto", "ref", " Ref"):
        monkeypatch.setenv(name, raw)
        assert ENV.read_choice(name) == JENV.read_choice(name)
    monkeypatch.setenv(name, "cuda")
    assert ENV.read_choice(name) == "cuda"
    for raw in ("pallas", "interpret"):
        monkeypatch.setenv(name, raw)
        assert JENV.read_choice(name) == raw
        with pytest.raises(ValueError, match="TPU machinery"):
            ENV.read_choice(name)
    for name, values in (("REPRO_GATHER_VARIANT", ("full", "hbm")),
                         ("REPRO_INGEST_VARIANT", ("block", "hbm"))):
        for raw in values:
            monkeypatch.setenv(name, raw)
            assert JENV.read_choice(name) == raw
            with pytest.raises(ValueError, match="TPU machinery"):
                ENV.read_choice(name)
        monkeypatch.setenv(name, "auto")
        assert ENV.read_choice(name) is None
        monkeypatch.setenv(name, "junk")
        with pytest.raises(ValueError, match="unknown value 'junk'"):
            ENV.read_choice(name)


def test_registry_lists_what_the_port_reads():
    """The five overrides the port reads; the two whose consumers lie
    outside the reference's package are left out; unregistered names
    raise; env_table renders each."""
    want = {"REPRO_KERNEL_BACKEND", "REPRO_GATHER_VARIANT",
            "REPRO_INGEST_VARIANT", "REPRO_WIRE_FORMAT",
            "REPRO_TUNING_REGISTRY"}
    assert want <= set(ENV.registered())
    assert want | {"REPRO_BENCH_TINY", "REPRO_REGEN_GOLDENS"} <= set(
        JENV.registered())
    assert not {"REPRO_BENCH_TINY", "REPRO_REGEN_GOLDENS"} & set(
        ENV.registered())
    with pytest.raises(KeyError, match="unregistered env override"):
        ENV.read_flag("REPRO_BENCH_TINY")
    table = ENV.env_table()
    for name in want:
        assert f"`{name}`" in table
    with pytest.raises(ValueError, match="choice spec needs choices"):
        ENV.EnvSpec("REPRO_X", "choice")


def test_backend_precedence_matches_reference(monkeypatch):
    """explicit > REPRO_KERNEL_BACKEND > cfg.kernel_backend > auto, as the
    reference's resolve_backend (compared where both accept the values),
    and a malformed env value raises even under an explicit argument."""
    name = "REPRO_KERNEL_BACKEND"
    cfg_ref = dataclasses.replace(REDUCED, kernel_backend="ref")
    monkeypatch.delenv(name, raising=False)
    assert dispatch.resolve_backend(None, REDUCED) == "auto"
    assert dispatch.resolve_backend(None, cfg_ref) == "ref"
    assert (dispatch.resolve_backend(None, cfg_ref)
            == JDISPATCH.resolve_backend(None, cfg_ref))
    monkeypatch.setenv(name, "ref")
    assert dispatch.resolve_backend(None, REDUCED) == "ref"
    assert dispatch.resolve_backend("auto", REDUCED) == "ref"
    assert (dispatch.resolve_backend("auto", REDUCED)
            == JDISPATCH.resolve_backend("auto", REDUCED))
    assert dispatch.resolve_backend("cuda", REDUCED) == "cuda"
    monkeypatch.setenv(name, "cuda")
    assert dispatch.resolve_backend(None, cfg_ref) == "cuda"
    assert dispatch.resolve_backend("ref", cfg_ref) == "ref"
    monkeypatch.setenv(name, "junk")
    for resolve in (dispatch.resolve_backend, JDISPATCH.resolve_backend):
        with pytest.raises(ValueError, match="unknown value 'junk'"):
            resolve("ref", cfg_ref)
    monkeypatch.setenv(name, "pallas")       # the reference's, not the port's
    with pytest.raises(ValueError, match="TPU machinery"):
        dispatch.resolve_backend("ref", cfg_ref)


def test_consumers_read_through_the_registry(monkeypatch):
    """DFASystem and Model take the env backend (and refuse a TPU one or a
    VMEM variant); core.wire takes the env wire format."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    assert DFASystem(REDUCED, device="cpu").backend == "ref"
    model = Model(get_config("granite-3-2b", reduced=True), device="cpu")
    assert model.backend == "ref"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    with pytest.raises(ValueError, match="TPU machinery"):
        DFASystem(REDUCED, device="cpu")
    with pytest.raises(ValueError, match="TPU machinery"):
        Model(get_config("granite-3-2b", reduced=True), device="cpu")
    monkeypatch.delenv("REPRO_KERNEL_BACKEND")
    monkeypatch.setenv("REPRO_INGEST_VARIANT", "hbm")
    with pytest.raises(ValueError, match="TPU machinery"):
        DFASystem(REDUCED, device="cpu")
    monkeypatch.delenv("REPRO_INGEST_VARIANT")
    monkeypatch.setenv("REPRO_WIRE_FORMAT", "v2")
    assert DFASystem(REDUCED, device="cpu").wire is WIRE.V2
    assert WIRE.ENV_VAR == ENV.WIRE_FORMAT.name
