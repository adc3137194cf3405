"""The reading of a profiler trace: device time and launches by span, the
busy union, the breakdown, on a trace written by hand."""
from types import SimpleNamespace

from bench.harness import reader
from bench.trace import TraceSummary


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.pipeline.ingest_half", 10, 400),
          _x("user_annotation", "bench.reporter.ingest", 20, 100),
          _x("user_annotation", "bench.pipeline.enrich_half", 500, 300),
          _x("cpu_op", "aten::sort", 30, 50),
          _x("cpu_op", "aten::where", 600, 100)]
    # (launch time, kernel start, duration, correlation)
    for t, start, dur, c in ((40, 50, 30, 1), (200, 210, 40, 2),
                             (650, 700, 60, 3), (900, 950, 100, 4)):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", t, 5,
                     correlation=c))
        ev.append(_x("kernel", f"k{c}", start, dur, tid=7, correlation=c))
    ev.append(_x("gpu_memcpy", "Memcpy HtoD", 960, 20, tid=8, correlation=5))
    ev.append(_x("cuda_runtime", "cudaMemcpyAsync", 905, 5, correlation=5))
    return {"traceEvents": ev}


def test_device_time_by_span():
    s = TraceSummary(_trace())
    assert s.window_us == 1000
    assert s.device_us("reporter.ingest") == 30
    assert s.device_us("pipeline.ingest_half") == 70
    assert s.device_us("pipeline.enrich_half") == 60
    assert s.count("pipeline.ingest_half") == 2
    assert s.count("pipeline.enrich_half") == 1
    assert s.device_us("missing") == 0


def test_busy_union_and_breakdown():
    s = TraceSummary(_trace())
    # kernels 50-80, 210-250, 700-760, 950-1050 (clipped at 1000), the
    # copy 960-980 inside the last one
    assert s.busy_us == 30 + 40 + 60 + 50
    ops = dict(s.top_ops())
    assert abs(ops["k4"] - 100e-6) < 1e-15 and len(ops) == 5
    gaps = {k: round(v * 1e6, 6) for k, v in s.idle_gaps()}
    # each gap by the innermost span and host operation at its start
    assert gaps == {"outside spans / no host op": 50,
                    "reporter.ingest / aten::sort": 130,
                    "pipeline.ingest_half / no host op": 450,
                    "pipeline.enrich_half / no host op": 190}


def test_card_time_leaves_out_host_transfers():
    """The card's own busy time is the union without host-device copies;
    a copy on the card counts. The card's vectors per second divide the
    traced periods' vectors by it, and say nothing without it."""
    tr = _trace()
    s = TraceSummary(tr)
    # the HtoD copy lies inside k4: the union is the same without it
    assert s.compute_busy_us == s.busy_us == 180
    tr["traceEvents"].append(_x("gpu_memcpy", "Memcpy HtoD (Pinned -> "
                                "Device)", 100, 50, tid=8, correlation=6))
    tr["traceEvents"].append(_x("gpu_memcpy", "Memcpy DtoD (Device -> "
                                "Device)", 300, 20, tid=8, correlation=7))
    s = TraceSummary(tr)
    assert s.busy_us == 180 + 50 + 20
    assert s.compute_busy_us == 180 + 20
    read = reader("vectors_per_card_s")
    ctx = SimpleNamespace(trace=s, traced_vectors=400)
    assert abs(read(ctx) - 400 / 200e-6) < 1e-6
    assert read(SimpleNamespace(trace=s, traced_vectors=0)) is None
    assert read(SimpleNamespace(trace=None, traced_vectors=400)) is None
