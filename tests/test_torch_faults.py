"""The port's transport-fault injector against ``repro.data.faults``.

The reference draws its schedule from ``jax.random`` (threefry), which
torch does not reproduce, so the port splits ``inject`` into ``draw``
(every random choice, from a seeded ``torch.Generator``) and ``apply``
(the deterministic rest). Here the reference's own draws — rebuilt with
the same ``jax.random`` calls its ``inject`` makes — are fed to the
port's ``apply`` and held bit for bit against ``repro.data.faults.inject``
(payloads, mask, counts, ledger) for each fault class alone and mixed,
under V1 and V2; and a REDUCED ``run_periods`` with those draws patched
in equals the reference's ``run_periods`` under the same spec. The
port's own schedule is deterministic per (seed, now, salt) and keeps the
three accounting identities exact; an unarmed spec is bit-identical to
no spec.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JWIRE
from repro.data import faults as JF
from repro_torch import u32 as U
from repro_torch.configs import REDUCED, REDUCED_V2_WIDE
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE
from repro_torch.core.pipeline import DFASystem
from repro_torch.data import faults as FAULTS
from repro_torch.data.faults import FaultSpec
from test_torch_overlap import assert_streams_equal
from test_torch_pipeline import assert_state_equal, jax_system, traces

MIXED = FaultSpec(seed=7, drop_rate=0.15, dup_rate=0.1, flip_rate=0.1,
                  replay_rate=0.05, reorder_rate=0.3, reorder_window=4)
SPECS = {
    "drop": FaultSpec(seed=1, drop_rate=0.3),
    "dup": FaultSpec(seed=2, dup_rate=0.3),
    "flip": FaultSpec(seed=3, flip_rate=0.3),
    "replay": FaultSpec(seed=4, replay_rate=0.3),
    "reorder": FaultSpec(seed=5, reorder_rate=0.6, reorder_window=4),
    "mixed": MIXED,
}


def reference_draws(spec, R, wire_name, now, salt):
    """The draws ``repro.data.faults.inject`` makes, as FaultDraws."""
    wf = JWIRE.get(wire_name)
    key = jax.random.fold_in(jax.random.key(spec.seed), jnp.uint32(now))
    key = jax.random.fold_in(key, jnp.uint32(salt))
    k_reord, k_u, k_word, k_bit, k_scram = jax.random.split(key, 5)

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64))

    perm = word = bit = scram = None
    if spec.reorder_rate > 0:
        perm = t(JF._blockwise_permutation(k_reord, R, spec.reorder_window,
                                           spec.reorder_rate))
    u = torch.from_numpy(np.array(jax.random.uniform(k_u, (R,))))
    if spec.flip_rate > 0:
        word = t(jax.random.randint(k_word, (R,), 0, wf.payload_words))
        bit = t(jax.random.randint(k_bit, (R,), 0, 32))
    if spec.replay_rate > 0:
        sl = wf.payload_stats_slice
        scram = t(jax.random.randint(k_scram, (R, sl.stop - sl.start), 1,
                                     1 << 30).astype(jnp.uint32))
    return FAULTS.FaultDraws(perm, u, word, bit, scram)


def payload_batch(wire_name, R=96, seed=0):
    """Translated-looking payloads: random words, 3 reporters with
    consecutive seqs, hist in [0, 10), a valid checksum; ~90 % masked
    on."""
    wf = WIRE.get(wire_name)
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(0, 1 << 32, (R, 16),
                                          dtype=np.uint64).astype(np.int64))
    rep = torch.from_numpy(rng.integers(0, 3, R))
    seq = torch.zeros(R, dtype=torch.int64)
    for r in range(3):
        rows = rep == r
        seq[rows] = torch.arange(int(rows.sum())) + 17 * r
    hist = torch.from_numpy(rng.integers(0, 10, R))
    for w, v in wf.payload_meta_words(rep, seq, hist).items():
        words[:, w] = v                  # the meta words, as translated
    pos = PROTO.covered_positions(wf, "cpu")
    words[:, wf.csum_word] = PROTO.xor_checksum(words[:, pos], pos)
    pay = U.narrow(words)
    assert bool(PROTO.payload_valid(pay, wire=wf).all())
    mask = torch.from_numpy(rng.random(R) < 0.9)
    return pay, mask


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="probability"):
        FaultSpec(drop_rate=1.5)
    with pytest.raises(ValueError, match="probability"):
        FaultSpec(flip_rate=-0.1)
    with pytest.raises(ValueError, match="sum"):
        FaultSpec(drop_rate=0.5, dup_rate=0.4, flip_rate=0.3)
    with pytest.raises(ValueError, match="reorder_window"):
        FaultSpec(reorder_rate=0.5, reorder_window=1)
    assert not FaultSpec().armed
    assert FaultSpec().describe() == "none"
    assert FaultSpec(reorder_rate=0.1).armed
    assert not FaultSpec(reorder_rate=0.1).appends_copies
    assert FaultSpec(dup_rate=0.1).appends_copies
    s = MIXED.describe()
    assert s.startswith("seed=7,") and "drop_rate=0.15" in s
    assert s == JF.FaultSpec(**dataclasses.asdict(MIXED)).describe()


@pytest.mark.parametrize("wire", ["v1", "v2"])
@pytest.mark.parametrize("name", list(SPECS))
def test_apply_with_reference_draws_matches_inject(name, wire):
    spec = SPECS[name]
    pay, mask = payload_batch(wire, seed=len(name))
    now, salt = 100_000 + len(name), 0
    jpay, jmask, jcounts, jledger = JF.inject(
        jnp.asarray(pay.numpy().view(np.uint32)), jnp.asarray(mask.numpy()),
        JF.FaultSpec(**dataclasses.asdict(spec)), JWIRE.get(wire),
        jnp.uint32(now), jnp.int32(salt))
    draws = reference_draws(spec, pay.shape[0], wire, now, salt)
    tpay, tmask, tcounts, tledger = FAULTS.apply(pay, mask, spec,
                                                 WIRE.get(wire), draws)
    np.testing.assert_array_equal(np.asarray(jpay).view(np.int32),
                                  tpay.numpy())
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    assert sorted(jcounts) == sorted(tcounts) == sorted(FAULTS.COUNT_KEYS)
    for k in jcounts:
        assert int(jcounts[k]) == int(tcounts[k]), k
    assert sorted(jledger) == sorted(tledger) == sorted(FAULTS.LEDGER_KEYS)
    for k in jledger:
        np.testing.assert_array_equal(np.asarray(jledger[k]).astype(np.int64),
                                      tledger[k].numpy(), err_msg=k)
    cls = {"drop": "injected_drops", "dup": "injected_dups",
           "flip": "injected_flips", "replay": "injected_replays",
           "reorder": "injected_reorders"}.get(name)
    if cls is not None:
        assert int(tcounts[cls]) > 0, "the class never fired"


def test_blockwise_permutation_bounded():
    R, W = 64, 4
    g = torch.Generator().manual_seed(3)
    perm = FAULTS.blockwise_permutation(torch.ones(R // W, dtype=bool),
                                        torch.rand(R, generator=g), W)
    assert sorted(perm.tolist()) == list(range(R))
    assert torch.equal(perm // W, torch.arange(R) // W)
    assert bool((perm != torch.arange(R)).any())
    ident = FAULTS.blockwise_permutation(torch.zeros(R // W, dtype=bool),
                                         torch.rand(R, generator=g), W)
    assert torch.equal(ident, torch.arange(R))


def patched_draw(wire_name):
    def draw(spec, R, wire, now, salt, device):
        assert wire.name == wire_name
        return reference_draws(spec, R, wire_name, now, salt)
    return draw


@pytest.mark.parametrize("overlapped", [False, True])
def test_run_periods_with_reference_draws_matches_jax(monkeypatch,
                                                      overlapped):
    js = jax_system(fault_spec=JF.FaultSpec(**dataclasses.asdict(MIXED)))
    ts = DFASystem(dataclasses.replace(REDUCED, fault_spec=MIXED),
                   device="cpu")
    jev, jnows, tev, tnows = traces(T=3, n_flows=100, flow_seed=2)
    with js.mesh:
        jout = jax.jit(js.run_periods)(js.init_state(), jev, jnows)
    monkeypatch.setattr(FAULTS, "draw", patched_draw("v1"))
    tout = ts.stream(ts.init_state(), tev, tnows, overlapped=overlapped)
    assert_state_equal(jout.state, tout.state)
    assert sorted(jout.metrics) == sorted(tout.metrics)
    for k, v in jout.metrics.items():
        np.testing.assert_array_equal(np.asarray(v).astype(np.int64),
                                      tout.metrics[k].numpy(), err_msg=k)
    assert tout.metrics["fault_kind"].shape == (3, 2 * REDUCED.report_capacity)
    assert int(tout.metrics["injected_drops"].sum()) > 0


def test_own_schedule_is_deterministic():
    wf = WIRE.get("v2")
    a = FAULTS.draw(MIXED, 96, wf, 100, 0, "cpu")
    b = FAULTS.draw(MIXED, 96, wf, 100, 0, "cpu")
    c = FAULTS.draw(MIXED, 96, wf, 100, 1, "cpu")
    d = FAULTS.draw(MIXED, 96, wf, 120, 0, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.u, c.u) and not torch.equal(a.u, d.u)
    assert a.u.dtype == torch.float32 and a.perm.shape == (96,)
    assert int(a.word.max()) < 16 and int(a.bit.max()) < 32
    assert int(a.scram.min()) >= 1 and a.scram.shape == (96, 7)
    pay, mask = payload_batch("v2")
    x = FAULTS.inject(pay, mask, MIXED, wf, 100, 0)
    y = FAULTS.apply(pay, mask, MIXED, wf, a)
    for p, q in zip(x[:2], y[:2]):
        assert torch.equal(p, q)


@pytest.mark.parametrize("cfg", [REDUCED, REDUCED_V2_WIDE],
                         ids=["v1", "v2-wide"])
def test_own_schedule_identities_exact(cfg):
    """Per period: Δbad_checksum == flips, Δseq_anomalies == dups +
    replays, Δlost_reports == drops + flips — inside one wrap of the
    wire's seq (V1: 256 reports in all), the regime the identities hold
    in (the reference's own suite keeps to it too)."""
    ts = DFASystem(dataclasses.replace(cfg, fault_spec=MIXED), device="cpu")
    E, n = (128, 60) if cfg is REDUCED else (2048, 1500)
    _, _, tev, tnows = traces(T=4, E=E, n_flows=n, flow_seed=1)
    m = {k: v.numpy() for k, v in
         ts.run_periods(ts.init_state(), tev, tnows).metrics.items()}
    np.testing.assert_array_equal(m["bad_checksum"], m["injected_flips"])
    np.testing.assert_array_equal(m["seq_anomalies"],
                                  m["injected_dups"] + m["injected_replays"])
    np.testing.assert_array_equal(m["lost_reports"],
                                  m["injected_drops"] + m["injected_flips"])
    for k in FAULTS.COUNT_KEYS:
        assert m[k].sum() > 0, k
    assert m["reports_sent"].sum() < WIRE.resolve(cfg).seq_mask + 1


def test_unarmed_spec_is_clean():
    ts = DFASystem(dataclasses.replace(REDUCED, fault_spec=FaultSpec()),
                   device="cpu")
    clean = DFASystem(REDUCED, device="cpu")
    assert ts.fault_spec is None
    assert ts.describe()["fault_injection"] == "none"
    _, _, tev, tnows = traces(T=3, n_flows=60)
    a = ts.run_periods(ts.init_state(), tev, tnows)
    b = clean.run_periods(clean.init_state(), tev, tnows)
    assert not set(FAULTS.COUNT_KEYS + FAULTS.LEDGER_KEYS) & set(a.metrics)
    assert_streams_equal(a, b)
