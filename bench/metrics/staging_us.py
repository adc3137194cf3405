"""Host µs per period of trace replay and staging (``TraceReplaySource``
assembly into the pinned slot, then ``HostIngestRing.stage``): the mean
of ``ServingLoop``'s ``replay`` + ``stage`` splits over the measured
window."""


def read(ctx):
    host = getattr(ctx.driver, "host_us", None)
    if not host:
        return None
    parts = list(zip(host["replay"], host["stage"]))
    return sum(a + b for a, b in parts) / len(parts)
