"""Quickstart on the PyTorch port: the paper's loop in a page — packets
in, per-flow Table-I features extracted at the reporter, routed to the
collector, placed in the Fig-4 ring buffer, enriched, ready for
inference.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card by default, where the period launches the
hand-written kernels (reporter ingest, ring placement, gather +
enrichment); ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.core.pipeline import DFASystem  # noqa: E402
from repro_torch.data import packets as PK  # noqa: E402

PERIODS, N_FLOWS, EVENTS = 3, 32, 512


def run(device="cuda", log=print):
    """Three monitoring periods of 512 packets from 32 flows on the
    REDUCED system. Returns {"periods": [per-period counts and means],
    "ring_entries": ring entries written}."""
    cfg = REDUCED
    system = DFASystem(cfg, device=device)
    state = system.init_state()
    flows = PK.gen_flows(N_FLOWS, seed=0)
    log(f"monitoring {len(flows['rate'])} flows on {system.device}, "
        f"period={cfg.monitoring_period_us / 1000:.0f} ms, "
        f"history={cfg.history} entries/flow")
    rows = []
    for period in range(PERIODS):
        ev = PK.events_to_torch(
            PK.events_for_shards(flows, period, system.n_shards, EVENTS,
                                 window_us=cfg.monitoring_period_us),
            system.device)
        now = (period + 1) * cfg.monitoring_period_us * 2
        out = system.dfa_step(state, ev, now)
        state, metrics = out.state, out.metrics
        en = out.enriched[out.mask]
        row = {"reports_sent": int(metrics["reports_sent"]),
               "features": int(out.mask.sum()),
               "mean_pkts": float(en[:, 0].mean()),
               "mean_rate": float(en[:, 12].mean()),
               "bad_checksum": int(metrics["bad_checksum"])}
        rows.append(row)
        log(f"period {period}: {row['reports_sent']} reports -> "
            f"{row['features']} feature vectors (mean pkts/flow "
            f"{row['mean_pkts']:.1f}, mean rate "
            f"{row['mean_rate'] / 1e6:.2f} Mb/s, checksum errors "
            f"{row['bad_checksum']})")
    ring = int(state.collector.entry_valid.sum())
    log(f"collector ring entries written: {ring} (64 B each, verbatim "
        f"RoCEv2 payloads)")
    return {"periods": rows, "ring_entries": ring}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
