"""Train a flow classifier on DFA-enriched features with the PyTorch port
(the paper's "training new models on smaller intervals" direction, §VI).

    PYTHONPATH=src python examples/torch_train_flow_classifier.py \\
        [--device cpu]

Generates two synthetic traffic classes (mice and elephants), runs them
through the full DFA period on the port, and trains a small MLP on the
enriched feature vectors with the port's own AdamW and LR schedule.
Reports accuracy on held-out feature vectors. Runs on the CUDA card by
default; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import u32 as U  # noqa: E402
from repro_torch.configs import REDUCED, TrainConfig  # noqa: E402
from repro_torch.core.pipeline import DFASystem  # noqa: E402
from repro_torch.core.reporter import hash_slot  # noqa: E402
from repro_torch.data import packets as PK  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import lr_at  # noqa: E402

HIDDEN, STEPS = 64, 200
TCFG = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=STEPS,
                   weight_decay=0.01)


def collect_features(system, periods=6, n_flows=32, seed=0):
    """(X (N, derived_dim) f32, y (N,) int32): every enriched feature
    vector of a labelled flow over ``periods`` periods. Label 1 flows send
    24 large packets a period, label 0 flows 6 small ones (the same numpy
    draws as the reference's example)."""
    rng = np.random.default_rng(seed)
    state = system.init_state()
    cfg = system.cfg
    X, y = [], []
    keys = rng.integers(1, 2**31, (n_flows, 5)).astype(np.uint32)
    lab = rng.integers(0, 2, n_flows)
    slots = hash_slot(U.from_numpy(keys), cfg.flows_per_shard).tolist()
    slot2lab = {int(s): lab[i] for i, s in enumerate(slots)}
    for period in range(periods):
        evs = []
        for i in range(n_flows):
            cnt = 24 if lab[i] else 6
            ts = np.sort(rng.integers(0, 20_000, cnt)) + period * 100_000
            size = (rng.integers(1000, 1514, cnt) if lab[i]
                    else rng.integers(40, 200, cnt))
            evs.append((ts, size, np.tile(keys[i], (cnt, 1))))
        ts = np.concatenate([e[0] for e in evs]).astype(np.uint32)
        order = np.argsort(ts, kind="stable")
        ev = PK.events_to_torch(
            {"ts": ts[order],
             "size": np.concatenate([e[1] for e in evs]).astype(
                 np.uint32)[order],
             "five_tuple": np.concatenate([e[2] for e in evs]).astype(
                 np.uint32)[order],
             "valid": np.ones(len(ts), bool)}, system.device)
        out = system.dfa_step(state, ev, (period + 1) * 100_000)
        state = out.state
        en = out.enriched[out.mask].cpu().numpy()
        fid = out.flow_ids[out.mask].cpu().numpy()
        for j in range(len(fid)):
            sl = int(fid[j]) % cfg.flows_per_shard
            if sl in slot2lab:
                X.append(en[j])
                y.append(slot2lab[sl])
    return np.asarray(X, np.float32), np.asarray(y, np.int32)


def prepare(X, y):
    """log1p-squash and standardise; the first 70 % train, the rest
    held out."""
    X = np.log1p(np.abs(X))
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    n = len(X)
    cut = int(n * 0.7)
    return X[:cut], y[:cut], X[cut:], y[cut:]


def init_mlp(D, device, seed=0):
    """N(0, 0.1^2) weights from a ``torch.Generator``, zero biases."""
    g = torch.Generator().manual_seed(seed)
    return {"w1": (0.1 * torch.randn(D, HIDDEN, generator=g)).to(device),
            "b1": torch.zeros(HIDDEN, device=device),
            "w2": (0.1 * torch.randn(HIDDEN, 2, generator=g)).to(device),
            "b2": torch.zeros(2, device=device)}


def logits(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def train(params, Xtr, ytr, steps=STEPS, tcfg=TCFG, log=print):
    """Full-batch AdamW steps on the cross-entropy; returns (params,
    per-step losses)."""
    opt = adamw.init(params, tcfg)
    losses = []
    for step in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = -torch.log_softmax(logits(live, Xtr), -1)[
            torch.arange(len(ytr), device=Xtr.device), ytr].mean()
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        params, opt, _ = adamw.apply(params, grads, opt, tcfg,
                                     lr_at(opt.step, tcfg))
        losses.append(float(loss.detach()))
        if step % 50 == 0:
            log(f"step {step:3d} loss {losses[-1]:.4f}")
    return params, losses


def accuracy(params, X, y) -> float:
    with torch.no_grad():
        return float((logits(params, X).argmax(-1) == y).float().mean())


def run(device="cuda", init_params=None, log=print):
    """Collect, train for 200 steps, test. ``init_params`` (numpy {"w1",
    "b1", "w2", "b2"}) replaces the seeded initial weights. Returns {"X",
    "y", "losses", "accuracy", "params"}."""
    system = DFASystem(REDUCED, device=device)
    X, y = collect_features(system)
    Xtr, ytr, Xte, yte = prepare(X, y)
    dev = system.device
    log(f"collected {len(X)} enriched feature vectors "
        f"({REDUCED.derived_dim}-dim) through the DFA pipeline on {dev}")
    params = (init_mlp(X.shape[1], dev) if init_params is None else
              {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
               for k, v in init_params.items()})
    t = lambda a: torch.from_numpy(a).to(dev)
    params, losses = train(params, t(Xtr), t(ytr).long(), log=log)
    acc = accuracy(params, t(Xte), t(yte).long())
    log(f"held-out accuracy: {acc:.3f} (mice vs elephants from Table-I "
        f"moment features)")
    assert acc > 0.85
    return {"X": X, "y": y, "losses": losses, "accuracy": acc,
            "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
