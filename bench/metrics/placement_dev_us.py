"""Device µs per period inside ``collector.ingest`` (checksum and seq
checks, ring placement: K2), traced window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.driver.n_traced:
        return None
    us = tr.device_us("collector.ingest")
    return us / ctx.driver.n_traced if us > 0 else None
