"""The port's four examples (``examples/torch_*.py``) against the JAX
package's on the CPU.

Each reference example's loop is rebuilt here from the reference's own
API, as its ``main`` runs it, and held against the port example's
``run``: the quickstart's per-period counts and means; the serving
example's accounting, verdicts, stage-2 rows and generated tokens, with
the reference's head weights and one numpy draw of its LM weights
(``torch_cross.cross``: JAX's LM init is salted per process, so its
draws change from run to run) carried across as numpy; the flow
classifier's features and labels, its first 5 AdamW steps from the
reference's initial weights on the same data, and its held-out accuracy;
the LM example's falling loss. Tolerances: f32 means 1e-5 relative,
features 1e-5 of each row's feature scale
(``tests/test_gather_enrich_equiv.py``), the MLP's parameters 1e-5 of
each leaf's largest element.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dfa_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.pipeline import DFASystem as JSystem
from repro.data import packets as JPK
from repro.launch.serve import serve as jax_serve
from repro.launch.serving import ServingLoop as JLoop
from repro.launch.serving import build_source as jax_build_source
from repro.optim import adamw as JADAMW
from repro.optim.schedule import lr_at as jax_lr_at
from repro_torch.configs import REDUCED
from repro_torch.core.pipeline import DFASystem
from test_gather_enrich_equiv import assert_feature_close
from torch_cross import cross

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(name):
    """An example script as a module (without running its ``main``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QUICK = _load("torch_quickstart")
SERVING = _load("torch_serve_traffic_inference")
CLASSIFIER = _load("torch_train_flow_classifier")
LM_E2E = _load("torch_train_lm_e2e")
quiet = lambda *a, **k: None


def test_quickstart_matches_the_reference(mesh):
    got = QUICK.run("cpu", log=quiet)
    cfg = get_dfa_config(reduced=True)
    system = JSystem(cfg, mesh)
    state = system.init_state()
    step = jax.jit(system.dfa_step)
    flows = JPK.gen_flows(QUICK.N_FLOWS, seed=0)
    with mesh:
        for period, row in enumerate(got["periods"]):
            ev = JPK.events_for_shards(flows, period, system.n_shards,
                                       QUICK.EVENTS,
                                       window_us=cfg.monitoring_period_us)
            now = jnp.uint32((period + 1) * cfg.monitoring_period_us * 2)
            out = step(state, {k: jnp.asarray(v) for k, v in ev.items()},
                       now)
            state, metrics = out.state, out.metrics
            en = np.asarray(out.enriched)[np.asarray(out.mask)]
            assert row["reports_sent"] == int(metrics["reports_sent"])
            assert row["features"] == int(np.asarray(out.mask).sum())
            assert row["bad_checksum"] == int(metrics["bad_checksum"])
            np.testing.assert_allclose(row["mean_pkts"], en[:, 0].mean(),
                                       rtol=1e-5)
            np.testing.assert_allclose(row["mean_rate"], en[:, 12].mean(),
                                       rtol=1e-5)
    assert got["ring_entries"] == int(np.asarray(
        state.collector.entry_valid).sum())
    assert len(got["periods"]) == QUICK.PERIODS


def test_serving_example_matches_the_reference(mesh):
    """The reference example's loop on its head's weights and a numpy
    draw of its LM's; the port's run on the same weights: the same accounting (balanced, with drops), the
    same verdicts over the final period's flows, the same stage-2 rows
    and flow ids, the same generated tokens."""
    base = get_dfa_config(reduced=True)
    ours = SERVING.serving_config()
    cap = base.event_block / (base.monitoring_period_us / 1e6)
    cfg = dataclasses.replace(base, inference_head="linear",
                              inference_classes=8,
                              serve_offered_eps=1.25 * cap,
                              serve_queue_events=2 * base.event_block,
                              drop_policy="newest")
    for f in ("inference_head", "inference_classes", "serve_offered_eps",
              "serve_queue_events", "drop_policy", "event_block"):
        assert getattr(ours, f) == getattr(cfg, f), f
    system = JSystem(cfg, mesh)
    events, nows = JPK.period_batches(system.n_shards, 4, cfg.event_block,
                                      n_flows=24, flow_seed=3)
    jm, jp, _, _ = cross("granite-3-2b", "bfloat16", mesh)
    with mesh:
        report = JLoop(system, jax_build_source(system, events, nows)).run(
            SERVING.PERIODS)
        out = report.last
        em = np.asarray(out.mask)
        verdicts = np.asarray(jnp.argmax(out.preds, axis=-1))
        scores = np.asarray(jax.nn.logsumexp(out.preds, axis=-1))
        rows = np.nonzero(em)[0]
        rows = rows[np.argsort(-scores[rows])][:SERVING.TOP]
        B = max(1, len(rows))
        vtok = jnp.asarray(verdicts[rows].reshape(B, 1) + 1, jnp.int32)
        prompt = {"tokens": jnp.concatenate(
            [jnp.zeros((B, 4), jnp.int32), jnp.tile(vtok, (1, 4))], axis=1)}
        toks, _ = jax_serve(jm, jp, prompt, SERVING.PROMPT, SERVING.GEN,
                            SERVING.CACHE)

    got = SERVING.run(
        "cpu", head_params={k: np.asarray(v)
                            for k, v in system.infer_params.items()},
        lm_params=jax.tree.map(np.asarray, jp), log=quiet)
    r = got["report"]
    assert r.balanced and r.dropped > 0
    for f in ("periods", "drained_periods", "offered", "processed",
              "dropped"):
        assert getattr(r, f) == getattr(report, f), f
    np.testing.assert_array_equal(got["mask"], em)
    np.testing.assert_array_equal(got["verdicts"][em], verdicts[em])
    np.testing.assert_allclose(got["scores"][em], scores[em], rtol=1e-5)
    np.testing.assert_array_equal(got["rows"], rows)
    np.testing.assert_array_equal(got["flow_ids"][rows],
                                  np.asarray(out.flow_ids)[rows])
    np.testing.assert_array_equal(got["tokens"], np.asarray(toks))


@pytest.fixture(scope="module")
def classifier(mesh):
    """(the reference example module, its X and y, the port's X and y)."""
    ref = _load("train_flow_classifier")
    with mesh:
        jx, jy = ref.collect_features(JSystem(get_dfa_config(reduced=True),
                                              mesh))
    tx, ty = CLASSIFIER.collect_features(DFASystem(REDUCED, device="cpu"))
    return ref, jx, jy, tx, ty


def test_classifier_features_match_the_reference(classifier):
    _, jx, jy, tx, ty = classifier
    assert len(jy) > 100 and set(np.unique(jy)) == {0, 1}
    np.testing.assert_array_equal(ty, jy)
    assert_feature_close(tx, jx, 1e-5)


def test_classifier_first_adamw_steps_match_the_reference(classifier):
    """5 AdamW steps of the reference's training step and of the port's
    ``train``, from the reference's initial weights, on the same
    standardised training split."""
    _, jx, jy, _, _ = classifier
    Xtr, ytr, _, _ = CLASSIFIER.prepare(jx, jy)
    k1, k2 = jax.random.split(jax.random.key(0))
    init = {"w1": 0.1 * jax.random.normal(k1, (jx.shape[1], 64)),
            "b1": jnp.zeros(64),
            "w2": 0.1 * jax.random.normal(k2, (64, 2)),
            "b2": jnp.zeros(2)}
    tcfg = JTrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=200,
                        weight_decay=0.01)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        JTrainConfig(**{f: getattr(CLASSIFIER.TCFG, f)
                        for f in dataclasses.asdict(tcfg)}))

    def loss_fn(p, xb, yb):
        h = jax.nn.relu(xb @ p["w1"] + p["b1"])
        lg = h @ p["w2"] + p["b2"]
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(len(yb)), yb])

    p, opt = init, JADAMW.init(init, tcfg)
    jl = []
    for _ in range(5):
        l, g = jax.value_and_grad(loss_fn)(p, jnp.asarray(Xtr),
                                           jnp.asarray(ytr))
        p, opt, _ = JADAMW.apply(p, g, opt, tcfg, jax_lr_at(opt.step, tcfg))
        jl.append(float(l))
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in init.items()}
    got, tl = CLASSIFIER.train(tp, torch.from_numpy(Xtr),
                               torch.from_numpy(ytr).long(), steps=5,
                               log=quiet)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in init:
        want = np.asarray(p[k])
        err = float(np.abs(got[k].numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), k


def test_classifier_example_reaches_the_reference_accuracy():
    """The whole example on the CPU, its own seeded weights: held-out
    accuracy > 0.85 (the reference example's bar)."""
    out = CLASSIFIER.run("cpu", log=quiet)
    assert out["accuracy"] > 0.85 and len(out["losses"]) == CLASSIFIER.STEPS


def test_lm_example_loss_falls(tmp_path):
    losses = LM_E2E.run("cpu", steps=30, ckpt_dir=tmp_path, log=quiet)
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    assert os.path.isdir(tmp_path / "step_30")
