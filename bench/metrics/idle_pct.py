"""Share of the traced window in which no device operation runs, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
