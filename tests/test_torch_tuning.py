"""The port's tuned-config registry (``repro_torch.kernels.tuning``)
against the reference's (``repro.kernels.tuning``), and K1's event tile
taken from it.

A file saved by one package loads in the other and both save the same
bytes; the armed-path precedence (env > ``DFAConfig.tuning_registry``)
and the failures (a malformed file, an unknown schema or knob, a tile
below 1) are the reference's; ``describe()`` names the armed file; a
REDUCED period with the fused ingest's event tile set to 64, 128 and 256
through a registry gives the reference's state bit for bit.
"""
import dataclasses
import json

import jax
import pytest

from repro.kernels import tuning as JTU
from repro_torch.configs import REDUCED
from repro_torch.core.pipeline import DFASystem
from repro_torch.kernels import dispatch
from repro_torch.kernels import tuning as TU
from repro_torch.kernels.ingest_update import ops as INGEST
from test_torch_pipeline import assert_state_equal, jax_system, traces

KNOB = "ingest_update.event_tile"
ENTRIES = [("ingest_update.event_tile", "cuda", (1 << 20,), 128, 27.5, "a"),
           ("ingest_update.event_tile", "cuda", (1 << 20,), 256, 30.1, "b"),
           ("ingest_update.event_tile", "ref", (512,), 64, 900.0, ""),
           ("gather_enrich.variant", "pallas", (8, 10, 64, 96), "hbm", 5.0,
            "sweep"),
           ("gather_enrich.report_tile", "interpret", (4096,), 512, 7.0, ""),
           ("ingest_update.variant", "pallas", (4096,), "block", 2.0, "")]


def _filled(module):
    reg = module.TuningRegistry()
    for e in ENTRIES:
        reg.record(*e[:5], source=e[5])
    return reg


def test_files_cross_between_packages(tmp_path):
    """The same entries save to the same bytes in both packages; each
    package loads the other's file; record keeps the fastest entry."""
    assert TU.SCHEMA == JTU.SCHEMA and TU.KNOBS == JTU.KNOBS
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    _filled(TU).save(str(ours))
    _filled(JTU).save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    for module, path in ((TU, theirs), (JTU, ours)):
        reg = module.TuningRegistry.load(str(path))
        assert reg.lookup(KNOB, "cuda", (1 << 20,)) == 128
        assert reg.lookup(KNOB, "ref", (512,)) == 64
        assert reg.lookup(KNOB, "ref", (1 << 20,)) is None
        assert reg.lookup("gather_enrich.variant", "pallas",
                          (8, 10, 64, 96)) == "hbm"


def test_precedence_and_failures_match_reference(tmp_path, monkeypatch):
    """REPRO_TUNING_REGISTRY > DFAConfig.tuning_registry > off, in both;
    a malformed file, a foreign schema and an unknown knob raise in both;
    a tuned tile below 1 raises; describe() names the armed path."""
    good = tmp_path / "good.json"
    _filled(TU).save(str(good))
    cfg = dataclasses.replace(REDUCED, tuning_registry=str(good))
    monkeypatch.delenv("REPRO_TUNING_REGISTRY", raising=False)
    for module in (TU, JTU):
        assert module.resolve_path(REDUCED) is None
        assert module.resolve_path(cfg) == str(good)
        assert module.lookup_value(REDUCED, KNOB, "ref", (512,)) is None
        assert module.lookup_value(cfg, KNOB, "ref", (512,)) == 64
    assert DFASystem(cfg, device="cpu").describe()["tuning_registry"] == \
        str(good)
    assert DFASystem(REDUCED, device="cpu").describe()[
        "tuning_registry"] == "none"
    assert dispatch.resolve_event_tile(cfg, 512, "ref") == 64
    assert dispatch.resolve_event_tile(cfg, 512, "cuda") == \
        REDUCED.event_tile
    assert dispatch.resolve_event_tile(REDUCED, 512, "ref") == \
        REDUCED.event_tile

    bad = {"malformed": '{"schema": "repro-tuning-v1", "entries": [{',
           "schema": json.dumps({"schema": "repro-tuning-v0",
                                 "entries": []}),
           "knob": json.dumps({"schema": "repro-tuning-v1", "entries": [
               {"knob": "ingest_update.tile", "backend": "ref",
                "key": [512], "value": 64, "us_per_call": 1.0}]})}
    for name, text in bad.items():
        path = tmp_path / f"{name}.json"
        path.write_text(text)
        monkeypatch.setenv("REPRO_TUNING_REGISTRY", str(path))
        for module in (TU, JTU):
            assert module.resolve_path(cfg) == str(path)
            with pytest.raises(ValueError):
                module.lookup_value(cfg, KNOB, "ref", (512,))
        with pytest.raises(ValueError):
            dispatch.resolve_event_tile(cfg, 512, "ref")
    zero = tmp_path / "zero.json"
    reg = TU.TuningRegistry()
    reg.record(KNOB, "ref", (512,), 0, 1.0)
    reg.save(str(zero))
    monkeypatch.setenv("REPRO_TUNING_REGISTRY", str(zero))
    with pytest.raises(ValueError, match="tiles must be >= 1"):
        dispatch.resolve_event_tile(REDUCED, 512, "ref")
    with pytest.raises(TypeError):
        reg.record(KNOB, "ref", (512,), 1.5, 1.0)


EVENTS = 512                 # one period: 8, 4 and 2 tiles of 64 / 128 / 256


def test_tuned_event_tile_keeps_the_reference_state(tmp_path, monkeypatch):
    """One REDUCED period (512 events from 200 flows, collisions
    included) with K1's tile set through a registry armed by
    REPRO_TUNING_REGISTRY: the fused ingest runs at that tile (its
    segment sums see it) and every state leaf equals the reference's
    period bit for bit, at 64, 128 and 256."""
    js = jax_system()
    jev, jnows, tev, tnows = traces(T=1, E=EVENTS, n_flows=200, flow_seed=1)
    with js.mesh:
        want = jax.jit(js.dfa_step)(js.init_state(),
                                    {k: v[0] for k, v in jev.items()},
                                    jnows[0]).state
    seen = []
    real = INGEST.segment_sums

    def spy(*args, tile, **kw):
        seen.append(tile)
        return real(*args, tile=tile, **kw)
    monkeypatch.setattr(INGEST, "segment_sums", spy)
    system = DFASystem(REDUCED, device="cpu")
    for tile in (64, 128, 256):
        path = tmp_path / f"tile{tile}.json"
        reg = TU.TuningRegistry()
        reg.record(KNOB, dispatch.route(tev["ts"]), (EVENTS,), tile, 1.0)
        reg.save(str(path))
        monkeypatch.setenv("REPRO_TUNING_REGISTRY", str(path))
        seen.clear()
        got = system.dfa_step(system.init_state(),
                              {k: v[0] for k, v in tev.items()}, tnows[0])
        assert seen == [tile]
        assert_state_equal(want, got.state, f"tile {tile}: ")
