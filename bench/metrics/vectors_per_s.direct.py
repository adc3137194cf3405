"""``vectors_per_s`` of the direct path, a per-layer metric: the masked
rows of every period completed in the measured window (the periods'
``reports_recv``), over the window's seconds on the host clock. The host
paces the period's dispatch, and its speed varies from run to run by more
than an end-to-end bound holds."""


def read(ctx):
    return ctx.vectors / ctx.driver.window_s
