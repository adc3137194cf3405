"""BENCHMARK.json against the contract's shape rules, and every piece a
cell is made of found by name."""
import json
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w["config"] for w in BENCH["workloads"]] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_piece_is_found_by_name():
    bench = ROOT / "bench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    for w in BENCH["workloads"]:
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert mix["entry"] in ("serving_loop", "stream")
        assert (bench / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        e2e = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and len(e2e) >= 2


def test_no_path_under_the_old_benchmarks():
    """Nothing in the benchmark's sources names the JAX package's
    benchmark folder or imports JAX or the JAX package."""
    bad = re.compile(r"benchmarks/|^\s*(import|from)\s+(jax|jaxlib|flax|repro)"
                     r"(\s|\.|$)", re.M)
    for p in (ROOT / "bench").rglob("*.py"):
        if p.parent.name == "tests":
            continue
        assert not bad.search(p.read_text()), p
