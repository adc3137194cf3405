"""End-to-end online serving on the PyTorch port: a continuous period
loop under a latency SLO — packets replayed at a configured offered rate,
host-staged through the double-buffered ingest ring, per-flow verdicts
from the streaming inference head every period, per-period wall latency
against the 20 ms budget with exact drop accounting. A small LM backbone
then takes the most suspicious flows of the final period as a second,
heavier stage.

    PYTHONPATH=src python examples/torch_serve_traffic_inference.py \\
        [--device cpu]

Pipeline: trace-replay source (paced events/s)
            -> HostIngestRing (pinned slots, copy stream on the card)
            -> dfa_step per period: ingest -> enrich -> per-flow verdict
               logits (models.flow_head, linear, 8 classes)
            -> ServingReport: p50/p99/p999 period latency, SLO
               violations, offered == processed + dropped
            -> the top flows' verdict classes become the prompt tokens
               for the granite-3-2b (reduced) backbone
               -> batched prefill + greedy decode (launch.serve).

Runs on the CUDA card by default (the DFA kernels and the prefill's
flash attention); ``--device cpu`` runs their plain versions.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import REDUCED, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.pipeline import DFASystem  # noqa: E402
from repro_torch.data import packets as PK  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.serving import ServingLoop, build_source  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402

PERIODS = 16
TOP = 4                       # flows handed to the LM
PROMPT, GEN, CACHE = 8, 8, 32


def serving_config():
    """REDUCED with the linear head (8 classes), offered 25 % above the
    batch-capacity rate into a queue of two event blocks, tail drop: so
    backpressure (queueing + drops) is exercised, not just configured."""
    cfg = dataclasses.replace(REDUCED, inference_head="linear",
                              inference_classes=8)
    capacity_eps = cfg.event_block / (cfg.monitoring_period_us / 1e6)
    return dataclasses.replace(cfg, serve_offered_eps=1.25 * capacity_eps,
                               serve_queue_events=2 * cfg.event_block,
                               drop_policy="newest")


def run(device="cuda", head_params=None, lm_params=None, log=print):
    """The serving loop for 16 periods (plus the drain), then the LM stage.
    ``head_params`` (numpy ``{"w", "b"}``) and ``lm_params`` (the dense
    LM's numpy tree) replace the seeded weights, so a test can hand in
    the reference's. Returns {"report", "verdicts", "mask", "scores",
    "rows", "flow_ids", "tokens"} (numpy, but the report)."""
    cfg = serving_config()
    system = DFASystem(cfg, device=device, infer_params=head_params)
    events, nows = PK.period_batches(system.n_shards, 4, cfg.event_block,
                                     n_flows=24, flow_seed=3)
    lm_cfg = get_config("granite-3-2b", reduced=True)
    model = Model(lm_cfg, device=system.device)
    params = (model.init(0) if lm_params is None
              else lm_params_from_numpy(lm_params, lm_cfg, system.device))

    t0 = time.perf_counter()
    report = ServingLoop(system, build_source(system, events, nows)).run(
        PERIODS)                          # drains the queue on shutdown
    out = report.last                     # StepOutputs, final period
    em = out.mask.cpu().numpy()
    preds = out.preds.float()
    verdicts = preds.argmax(-1).cpu().numpy()
    scores = torch.logsumexp(preds, -1).cpu().numpy()
    # stage 2: the highest-scoring flows of the final period go to the LM
    # backbone; each flow's prompt is its verdict class id (offset past
    # token 0), so different telemetry gives different stage-2 inputs
    rows = np.nonzero(em)[0]
    rows = rows[np.argsort(-scores[rows])][:TOP]
    B = max(1, len(rows))
    vcls = verdicts[rows] if len(rows) else np.zeros(1, np.int64)
    vtok = torch.from_numpy(vcls.reshape(B, 1).astype(np.int64) + 1)
    prompt = torch.cat([torch.zeros(B, PROMPT // 2, dtype=torch.int64),
                        vtok.repeat(1, PROMPT // 2)], 1).to(system.device)
    toks, tps = serve(model, params, {"tokens": prompt}, PROMPT, GEN, CACHE)
    dt = time.perf_counter() - t0

    lat = report.latency
    assert report.balanced, "accounting must close after drain"
    where = (torch.cuda.get_device_name(system.device)
             if system.device.type == "cuda" else "the CPU")
    log(f"{report.periods} serving periods (+{report.drained_periods} "
        f"drain) on {where}, SLO budget {report.budget_us / 1000:.0f} ms")
    log(f"offered {report.offered} == processed {report.processed} + "
        f"dropped {report.dropped} (exact, drop_policy={cfg.drop_policy})")
    log(f"period latency: p50 {lat['p50'] / 1000:.1f} ms, p99 "
        f"{lat['p99'] / 1000:.1f} ms, p999 {lat['p999'] / 1000:.1f} ms; "
        f"{report.violations} budget violations")
    log(f"sustained {report.sustained_eps:.3e} events/s of "
        f"{cfg.serve_offered_eps:.3e} offered")
    v, c = np.unique(verdicts[em], return_counts=True)
    log(f"final period: {int(em.sum())} flows enriched, verdict histogram "
        f"{dict(zip(v.tolist(), c.tolist()))}")
    flow_ids = out.flow_ids.cpu().numpy()
    log(f"stage-2 batch: {B} flows {flow_ids[rows]}")
    toks = toks.cpu().numpy()
    log(f"verdict tokens per flow: {toks[:, :6]}")
    log(f"end-to-end (serve loop + verdicts -> tokens) {dt * 1000:.0f} ms; "
        f"decode {tps:.1f} tok/s")
    return {"report": report, "verdicts": verdicts, "mask": em,
            "scores": scores, "rows": rows, "flow_ids": flow_ids,
            "tokens": toks}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
