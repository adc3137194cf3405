"""``reporter.ingest``'s share of its roofline, in %: the least time for
the bytes the traced periods' ingest needs (``roofline.ingest_bytes``:
the events once, the touched slots' register rows read and written
once) at the published bandwidth, over the device time in that span."""
from bench import roofline


def read(ctx):
    tr, d = ctx.trace, ctx.driver
    if tr is None or not d.n_traced:
        return None
    events = d.mix["events_per_port"] * ctx.ports
    n_bytes = sum(roofline.ingest_bytes(events, ctx.touched[d.trace_period(k)])
                  for k in range(d.n_periods, d.periods))
    return roofline.share_pct(n_bytes, tr.device_us("reporter.ingest") * 1e-6)
