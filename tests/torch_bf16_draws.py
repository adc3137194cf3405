"""The bf16 gradient rule of ``test_torch_hybrid`` over many draws of the
weights, on the CPU: for each draw, the port's and JAX's bf16 loss
gradients of zamba2-2.7b at REDUCED width against JAX's f32 ones, each
leaf's max |g - g_f32| / max |g_f32|. Prints each draw's worst-leaf
ratio (the port's worst leaf over JAX's) and both worst leaves, then the
ratios' spread and, per leaf, the geometric mean over the draws of the
port's error over JAX's with the standard error of its log.

    PYTHONPATH=src:tests python tests/torch_bf16_draws.py \\
        --hash-seeds 0-24 --numpy-seeds 0-3 --seq 40

A hash seed draws the reference's own init under that PYTHONHASHSEED
(``test_torch_hybrid._reference_inits``, ``--jobs`` processes at a time);
a numpy seed draws the tree with numpy (``_numpy_params``).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import hybrid as JHY  # noqa: E402
from repro.models.registry import get_model as jax_model  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from torch_cross import configs, perturbed  # noqa: E402
import test_torch_hybrid as TH  # noqa: E402


def seeds(text: str):
    """'0-3' or '0,5,13' -> a list of ints."""
    if not text:
        return []
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(x) for x in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hash-seeds", default="0-24")
    ap.add_argument("--numpy-seeds", default="0-3")
    ap.add_argument("--seq", type=int, default=TH.P)
    ap.add_argument("--jobs", type=int, default=4)
    a = ap.parse_args(argv)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jm, jm16 = (jax_model(configs(TH.ARCH, d)[0], mesh)
                for d in ("float32", "bfloat16"))
    tm16 = Model(configs(TH.ARCH, "bfloat16")[1], device="cpu")
    jb, tb = TH._batch(jm.cfg, S=a.seq)
    grads = [jax.jit(jax.value_and_grad(
        lambda p, b, cfg=m.cfg: JHY.hybrid_loss(p, b, cfg, mesh, ())))
        for m in (jm, jm16)]
    draws = {}
    hs = seeds(a.hash_seeds)
    with tempfile.TemporaryDirectory() as d:
        for i in range(0, len(hs), a.jobs):
            trees = TH._reference_inits(Path(d), hs[i:i + a.jobs])()
            draws.update({f"init, PYTHONHASHSEED {s}": perturbed(t)
                          for s, t in trees.items()})
    for s in seeds(a.numpy_seeds):
        draws[f"numpy draw {s}"] = TH._numpy_params(
            jax_config(TH.ARCH, reduced=True), s)
    port, ref = [], []
    for name, tree in draws.items():
        errs = TH._bf16_draw(tree, jm, jm16, tm16, *grads, jb, tb, mesh)
        port.append(errs[0])
        ref.append(errs[1])
        print(TH._draw_line(name, *errs), flush=True)
    r = np.array([max(p.values()) / max(q.values())
                  for p, q in zip(port, ref)])
    print(f"{len(r)} draws, {a.seq} tokens: worst-leaf ratio {r.min():.3f}"
          f"-{r.max():.3f}, geometric mean {np.exp(np.log(r).mean()):.3f}, "
          f"{int((r > 1.5).sum())} over 1.5")
    logs = {leaf: np.log([p[leaf] / q[leaf] for p, q in zip(port, ref)])
            for leaf in ref[0]}
    print("per leaf, geometric mean of port / JAX (standard error of its "
          "log): " + ", ".join(
              f"{k} {np.exp(v.mean()):.3f} ({v.std() / len(v) ** 0.5:.3f})"
              for k, v in sorted(logs.items(), key=lambda kv: -kv[1].mean())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
