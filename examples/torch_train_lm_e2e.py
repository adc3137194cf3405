"""End-to-end LM training on the PyTorch port: a few hundred steps of a
reduced architecture with the full substrate — fault-tolerant loop,
asynchronous checkpoints, step-keyed data, straggler watchdog.

    PYTHONPATH=src python examples/torch_train_lm_e2e.py \\
        [--arch granite-3-2b] [--steps 200] [--device cpu]

Runs on the CUDA card by default, where every layer's attention launches
the flash_attention kernel forward (K6) and its gradient (K7) backward;
``--device cpu`` runs their plain versions. ``chip_smoke.py`` trains
granite-3-2b at full width on the card.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import train as TR  # noqa: E402

CKPT_DIR = ROOT / "build" / "torch_example_ckpt"


def run(device="cuda", arch="granite-3-2b", steps=200, ckpt_dir=CKPT_DIR,
        log=print):
    """Train the reduced ``arch``; returns the per-step losses."""
    losses = TR.main(["--arch", arch, "--reduced", "--steps", str(steps),
                      "--batch", "8", "--seq", "128", "--lr", "3e-3",
                      "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "50",
                      "--log-every", "20", "--device", device])
    drop = losses[0] - sum(losses[-10:]) / 10
    log(f"loss dropped {drop:.3f} over {steps} steps (checkpoints in "
        f"{ckpt_dir})")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device, args.arch, args.steps)


if __name__ == "__main__":
    main()
