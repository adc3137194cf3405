"""``vectors_per_s`` of the served path, a per-layer metric there: the
masked rows of every period completed in the measured window, over the
window's seconds on the host clock. The host paces the served period, and
its speed varies from run to run by more than an end-to-end bound holds."""


def read(ctx):
    return ctx.vectors / ctx.driver.window_s
