"""CUDA kernels launched per period inside the program's period calls
(``dfa_step`` or ``stream``), counted in the traced window's profile."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.driver.n_traced:
        return None
    n = tr.count("pipeline.dfa_step") + tr.count("pipeline.stream")
    return n / ctx.driver.n_traced if n else None
