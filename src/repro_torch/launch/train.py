"""Fault-tolerant training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

Every ported id trains, the moe family (``--arch deepseek-v3-671b``,
with its multi-token-prediction loss, or ``llama4-scout-17b-a16e``) and
the hybrid family (``--arch zamba2-2.7b``), the ssm family (``--arch
rwkv6-3b``, attention-free), the encdec family (``--arch
whisper-tiny``, whose batches carry stub frames from
``data.tokens.add_modality_stub``) and the vlm family (``--arch
llava-next-mistral-7b``, whose batches carry stub patch embeddings before
the tokens; the loss is over the tokens) included; AdamW keeps its
moments in ``cfg.opt_state_dtype`` (bf16 under deepseek-v3's full
config).

Runs on the CUDA card by default (``--device cuda``), where attention
launches the flash_attention kernels (K6 forward, K7 backward). What it
keeps from the reference:
  * deterministic step-keyed data (``data.tokens``: exact resume),
  * periodic and SIGTERM checkpoints (atomic, keep-k, asynchronous;
    ``checkpoint.save`` / ``restore``), ``--resume`` from the newest,
  * the straggler watchdog (``StepMonitor``) and a heartbeat file.
The reference's gradient compression and pipeline stages act across
devices: one card has no data-parallel reduction to compress
(``TrainConfig`` refuses ``grad_compression``); their functions are
``optim.compression`` and ``distributed.pipeline``, over emulated ranks
(``launch.mesh.EmulatedMesh``).
"""
from __future__ import annotations

import argparse
import signal
from pathlib import Path

import numpy as np

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import tokens as DATA
from repro_torch.distributed.monitor import Heartbeat, StepMonitor
from repro_torch.launch import steps as ST
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import OptState

# checkpoints go under the repository's git-ignored build directory
CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "train_ckpt")


def rewrap_state(tree):
    """A restored state's optimizer part as an ``OptState`` (restore
    rebuilds it by name; this also takes a plain tuple)."""
    opt = tree["opt"]
    if not isinstance(opt, OptState):
        tree["opt"] = OptState(*opt)
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=-1)
    ap.add_argument("--schedule-steps", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    sched_total = args.schedule_steps if args.schedule_steps > 0 \
        else args.steps
    warmup = args.warmup if args.warmup >= 0 else max(sched_total // 10, 1)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=sched_total,
                       warmup_steps=warmup,
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    model = Model(cfg, device=args.device)
    dev = model.device
    step_fn = ST.make_train_step(model, tcfg)

    start = 0
    if args.resume and CKPT.latest_step(args.ckpt_dir) is not None:
        state, start = CKPT.restore(args.ckpt_dir, device=dev)
        state = rewrap_state(state)
        print(f"[train] resumed from step {start}")
    else:
        state = ST.init_train_state(model, tcfg, args.seed)

    monitor = StepMonitor()
    hb = Heartbeat(args.ckpt_dir + "/hb", 0)
    pending_save = None

    def save(state_, step_):
        nonlocal pending_save
        if pending_save is not None:
            pending_save.join()
        pending_save = CKPT.save(state_, args.ckpt_dir, step_,
                                 keep=tcfg.keep_checkpoints,
                                 async_=tcfg.async_checkpoint)

    stop = {"now": False}

    def on_term(sig, frame):
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_term)
    losses = []
    step = start
    try:
        for step in range(start, args.steps):
            monitor.start()
            batch = DATA.batch_at(step, cfg, args.batch, args.seq,
                                  args.seed, device=dev)
            batch = DATA.add_modality_stub(batch, cfg, step, args.seed)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])          # waits for the step
            losses.append(loss)
            m = monitor.stop()
            hb.beat(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"dt {m['step_time']:.3f}s", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                save(state, step + 1)
            if stop["now"]:
                print("[train] SIGTERM -> checkpoint + exit")
                save(state, step + 1)
                break
        save(state, min(step + 1, args.steps))
        if pending_save is not None:
            pending_save.join()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if not losses:
        print(f"[train] nothing to do: already at step {start}")
        return losses
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[train] done on {dev}: loss {first:.4f} -> {last:.4f} "
          f"({len(losses)} steps, slow_steps={monitor.slow_steps})")
    return losses


if __name__ == "__main__":
    main()
