"""Feature vectors per second of the card's own work: the vectors of the
traced periods (their ``reports_recv``) over the device time in which a
kernel, a memset or a copy on the card ran (the union of their
intervals), host-device transfers left out. Device trace of the traced
periods, which every run makes after its measured window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.compute_busy_us <= 0 or not ctx.traced_vectors:
        return None
    return ctx.traced_vectors / (tr.compute_busy_us * 1e-6)
