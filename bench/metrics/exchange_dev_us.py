"""Device µs per period of routing, the hash-home exchange and
translation: ``DFASystem.ingest_half`` less the reporter's and
placement's spans inside it, traced window."""

INNER = ("reporter.ingest", "reporter.due_flows", "reporter.make_reports",
         "collector.ingest")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.driver.n_traced:
        return None
    whole = tr.device_us("pipeline.ingest_half")
    us = whole - sum(tr.device_us(s) for s in INNER)
    return us / ctx.driver.n_traced if whole > 0 else None
