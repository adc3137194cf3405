"""95th percentile (linear interpolation) of the measured window's
per-period latencies, from a period's dispatch to its verdicts ready on
the host, in ms."""
import numpy as np


def read(ctx):
    lat = getattr(ctx.driver, "latency_us", None)
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=float), 95.0)) / 1e3
