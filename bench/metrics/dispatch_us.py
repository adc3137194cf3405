"""Host µs per period spent enqueueing it: ``ServingLoop``'s ``dispatch``
split (the ``dfa_step`` call) in the served path; in the direct path the
host time inside ``DFASystem.stream`` calls over the periods they
enqueue. Measured window."""


def read(ctx):
    host = getattr(ctx.driver, "host_us", None)
    if host:
        return sum(host["dispatch"]) / len(host["dispatch"])
    return getattr(ctx.driver, "dispatch_us", None)
