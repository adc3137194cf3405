"""Seconds from the start of ``run.py`` to the first timed period:
imports, the trace and weights, system construction, the kernels' build
or load, and the warm-up periods."""


def read(ctx):
    return ctx.setup_s
