"""Device µs per period inside the reporter's spans (``reporter.ingest``,
``due_flows``, ``make_reports``), traced window."""

SPANS = ("reporter.ingest", "reporter.due_flows", "reporter.make_reports")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.driver.n_traced:
        return None
    us = sum(tr.device_us(s) for s in SPANS)
    return us / ctx.driver.n_traced if us > 0 else None
