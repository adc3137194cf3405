"""The comparison that decides ``correct`` fails where it must: on each
fault a cell can have, planted in the program underneath a run of the
cell's small copy on the CPU, and on the control (the plain reference
one precision lower in the program's place)."""
import pytest
import torch

from conftest import CELLS, SEED, run_small, small_spec


def _state_unchanged(monkeypatch, n):
    from repro_torch.core import pipeline as PL
    orig = PL.DFASystem.ingest_half

    def half(self, state, events, now, backend=None):
        _, routed, m = orig(self, state, events, now, backend)
        return state, routed, m
    monkeypatch.setattr(PL.DFASystem, "ingest_half", half)


def _half_batch(monkeypatch, n):
    from repro_torch.core import pipeline as PL
    orig = PL.DFASystem.ingest_half

    def half(self, state, events, now, backend=None):
        ev = dict(events)
        v = ev["valid"].clone()
        v[v.shape[0] // 2:] = False
        ev["valid"] = v
        return orig(self, state, ev, now, backend)
    monkeypatch.setattr(PL.DFASystem, "ingest_half", half)


def _exchange_left_out(monkeypatch, n):
    """Each home keeps only the reports of its own port."""
    from repro_torch.core import translator as TRANS
    orig = TRANS.canonical_order
    calls = [0]

    def order(reports, mask, wire):
        d = calls[0] % n
        calls[0] += 1
        own = wire.report_reporter.extract(reports) == d
        return orig(reports, mask & own, wire=wire)
    monkeypatch.setattr(TRANS, "canonical_order", order)


def _feature_altered(monkeypatch, n):
    from repro_torch.core import collector as COLL
    orig = COLL.enrich_flow_history

    def enrich(*a, **k):
        """One report's features, all 1 % off."""
        out = orig(*a, **k).clone()
        i = int(out.abs().amax(-1).argmax())
        out[i] = out[i] * 1.01
        return out
    monkeypatch.setattr(COLL, "enrich_flow_history", enrich)


def _column_altered(col, change):
    def plant(monkeypatch, n):
        from repro_torch.core import collector as COLL
        orig = COLL.enrich_flow_history

        def enrich(*a, **k):
            """One small feature of the row with the largest, altered."""
            out = orig(*a, **k).clone()
            i = int(out.abs().amax(-1).argmax())
            out[i, col] = change(out[i, col])
            return out
        monkeypatch.setattr(COLL, "enrich_flow_history", enrich)
    return plant


def _register_bit(monkeypatch, n):
    from repro_torch.core import reporter as REP
    orig = REP.ingest

    def ingest(*a, **k):
        st = orig(*a, **k)
        regs = st.regs.clone()
        regs[0, 0] ^= 1
        return st._replace(regs=regs)
    monkeypatch.setattr(REP, "ingest", ingest)


def _logit_altered(monkeypatch, n):
    from repro_torch.models.flow_head import FlowHead
    orig = FlowHead.forward

    def forward(self, feats):
        out = orig(self, feats).clone()
        out[int(feats.abs().amax(-1).argmax())] += 0.05
        return out
    monkeypatch.setattr(FlowHead, "forward", forward)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "logit_altered": _logit_altered,
          # log1p(n) of the newest entry 1 % off; the largest hist_idx off
          # by one: small columns beside rates and skews of 1e6 and more
          "log1p_n_altered": _column_altered(17, lambda v: v * 1.01),
          "maxhist_altered": _column_altered(73, lambda v: v + 1),
          "exchange_left_out": _exchange_left_out,
          "feature_altered": _feature_altered,
          "register_bit": _register_bit}


# one port has no exchange to leave out
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if not (f == "exchange_left_out" and c.endswith(".served"))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_comparison(cell, fault, monkeypatch):
    spec = small_spec(cell)
    n = int(spec.config["n_shards"])
    FAULTS[fault](monkeypatch, n)
    result, lines = run_small(cell, spec=spec)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0


def test_one_ulp_of_a_feature_reads():
    """One ulp of one feature moves ``feature_gap`` off 0: the comparison
    reads the smallest change of an output. (A run cannot show it: the
    port's plain versions and the reference sum a window in different
    orders, so a clean run reads a few ulps already.)"""
    from bench import check, drivers, harness, traffic
    from bench.reference.config import from_fields
    from bench.reference.period import RefSystem
    spec = small_spec(CELLS[0])
    cfg = from_fields(spec.config["dfa"])
    head = harness.make_head(cfg, SEED, "cpu")
    ref = RefSystem(cfg, int(spec.config["n_shards"]), head=head)
    trace, nows = traffic.make_trace(spec.mix, ref.total_ports, SEED,
                                     torch.device("cpu"))
    state = ref.init_state()
    with torch.no_grad():
        for k in range(spec.mix["trace_periods"]):
            ev, now = drivers.INPUTS[spec.mix["entry"]](spec.mix, k, trace,
                                                        nows)
            state, out = ref.step(state, ev, now)

    def gap(enriched):
        cmp = check.Comparison(1, "cpu", head)
        cmp.outputs(0, (enriched, out.flow_ids, out.mask, out.preds), out,
                    spec.limits)
        return cmp.readings()["feature_gap"]
    assert gap(out.enriched) == 0.0
    got = out.enriched.clone()
    i, j = (int(x) for x in torch.nonzero(got.abs() > 1)[0])
    got[i, j] = torch.nextafter(got[i, j], torch.tensor(float("inf")))
    assert gap(got) > 0.0


def test_control_fails_the_comparison(cell):
    from bench import control
    spec = small_spec(cell)
    readings, passed = control.readings(spec, SEED, 6, torch.device("cpu"),
                                        sampled=3)
    assert passed is False, readings
    assert readings["words_differing"] == 0
    assert readings["feature_gap"] > spec.limits["feature_gap"]


def test_feature_scale_and_the_left_out_rows():
    """Each feature is held to its own size; the window's features to
    their operands'; a row leaves ``logit_gap`` only where a window
    feature's log1p moves by more than ``LEFT_OUT`` while the feature
    passes its limit."""
    from bench import check
    P = check.PER_ENTRY
    want = torch.zeros(4, 96)
    want[:, 5] = 6e14                      # the newest entry's IAT skew
    want[:, P + 5] = 6e14                  # its window mean
    want[:, 2 * P + 5] = 1e13              # its window std
    want[:, 17] = 7.5                      # log1p(n)
    want[:, 73] = 40.0                     # maxhist
    scale = check.feature_scale(want)
    assert scale[0, 17] == 7.5 and scale[0, 73] == 40.0
    assert scale[0, 0] == 1.0
    assert scale[0, 3 * P + 5] == 6e14 and scale[0, 2 * P + 5] == 6e14
    got = want.clone()
    got[0, 3 * P + 5] = 2.0 ** 26          # newest - mean: 0 against 1 ulp
    got[1, 3 * P + 5] = 1e12               # 0 against 1e12: past the limit
    want[2, 3 * P + 5] = 3e14              # a delta well above rounding,
    got[2, 3 * P + 5] = 3e14 + 2.0 ** 25   # off by an ulp
    assert check.ill_conditioned(got, want, 1e-5).tolist() == \
        [True, False, False, False]
