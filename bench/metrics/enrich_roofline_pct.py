"""``DFASystem.enrich_half``'s share of its roofline, in %: the least time
for the bytes the traced periods' enrichment and head need
(``roofline.enrich_bytes``: the reported flows' ring entries read once,
every output row's features and logits written once) at the published
bandwidth, over the device time in that span."""
from bench import roofline


def read(ctx):
    tr, d = ctx.trace, ctx.driver
    if tr is None or not d.n_traced:
        return None
    cfg = ctx.cfg
    recv = d.period_metrics("reports_recv")
    rows_out = next(iter(d.sampled.values()))[0].shape[0]
    n_bytes = sum(roofline.enrich_bytes(
        int(recv[k]), rows_out, cfg.history, cfg.derived_dim,
        cfg.inference_classes if cfg.inference_head != "none" else 0)
        for k in range(d.n_periods, d.periods))
    return roofline.share_pct(n_bytes,
                              tr.device_us("pipeline.enrich_half") * 1e-6)
