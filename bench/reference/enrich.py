"""Feature enrichment — the collector's derived-feature stage (§III-C).

From the seven Table-I registers of each history entry: per-entry means,
variances, std-devs, coefficients of variation and skewness of IAT and
packet size, volume and rate terms (18 features); then, per flow, the
newest entry's features, the window mean and two-pass std over the
valid entries, newest-minus-mean deltas, the valid count and the largest
hist_idx — 74 features, zero-padded to ``derived_dim``. This module is
plain PyTorch. ``dtype`` below float32 computes every feature in that
type (the lower-precision control of the benchmark's comparison).
"""
from __future__ import annotations

import torch

from . import u32 as U
from . import wire as WIRE

EPS = 1e-6
PER_ENTRY = 18


def entry_features(stats, dtype=torch.float32) -> torch.Tensor:
    """(..., 7) u32 Table-I registers -> (..., 18) derived features."""
    s = U.wide(stats).to(dtype)
    n = torch.clamp(s[..., 0], min=1.0)
    iat1, iat2, iat3 = s[..., 1], s[..., 2], s[..., 3]
    ps1, ps2, ps3 = s[..., 4], s[..., 5], s[..., 6]

    def moments(s1, s2, s3):
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        std = torch.sqrt(var)
        cov = std / torch.clamp(mean, min=EPS)
        m3 = s3 / n - 3 * mean * var - mean * mean * mean
        skew = m3 / torch.clamp(std * std * std, min=EPS)
        return mean, var, std, cov, skew

    i_mean, i_var, i_std, i_cov, i_skew = moments(iat1, iat2, iat3)
    p_mean, p_var, p_std, p_cov, p_skew = moments(ps1, ps2, ps3)
    duration = torch.clamp(iat1, min=1.0)
    volume = ps1
    rate_bps = volume * 8.0 / (duration / 1e6 + EPS)
    pps = n / (duration / 1e6 + EPS)
    return torch.stack([
        n, i_mean, i_var, i_std, i_cov, i_skew,
        p_mean, p_var, p_std, p_cov, p_skew,
        volume, rate_bps, pps, duration,
        torch.log1p(volume), torch.log1p(rate_bps), torch.log1p(n),
    ], dim=-1)


def _entry_sum(x: torch.Tensor) -> torch.Tensor:
    """(F, H, K) -> (F, K): the sum over the entries one entry at a time,
    in entry order, so that its rounding is the same on every device."""
    s = torch.zeros_like(x[:, 0])
    for h in range(x.shape[1]):
        s = s + x[:, h]
    return s


def derive_ref(memory_entries, entry_valid, cfg,
               dtype=torch.float32) -> torch.Tensor:
    """(F, H, 16) u32 + (F, H) bool -> (F, derived_dim) f32, computed in
    ``dtype``."""
    wf = WIRE.resolve(cfg)
    stats = memory_entries[..., wf.payload_stats_slice]
    hist_idx = wf.payload_hist.extract(memory_entries)
    feats = entry_features(stats, dtype)                 # (F, H, 18)
    vmask = entry_valid.to(dtype)[..., None]
    feats = feats * vmask
    nvalid = torch.clamp(entry_valid.sum(-1, keepdim=True), min=1
                         ).to(dtype)
    # newest entry = first index of the largest valid packet count
    count = torch.where(entry_valid, U.wide(stats[..., 0]), 0)
    newest = torch.argmax(count, dim=-1)
    newest_f = torch.gather(
        feats, 1, newest[:, None, None].expand(-1, 1, PER_ENTRY))[:, 0]
    mean_w = _entry_sum(feats) / nvalid
    dev = (feats - mean_w[:, None, :]) * vmask           # two-pass variance
    std_w = torch.sqrt(_entry_sum(dev * dev) / nvalid)
    delta = newest_f - mean_w
    maxhist = torch.where(entry_valid, hist_idx.to(dtype),
                          0.0).amax(-1, keepdim=True)
    out = torch.cat([newest_f, mean_w, std_w, delta, nvalid, maxhist],
                    dim=-1)
    D = out.shape[-1]
    if D < cfg.derived_dim:
        out = torch.nn.functional.pad(out, (0, cfg.derived_dim - D))
    return out[:, :cfg.derived_dim].to(torch.float32)


def gather_enrich(memory, entry_valid, local_flow, cfg, mask=None,
                  dtype=torch.float32) -> torch.Tensor:
    """(F, H, 16) ring + (F, H) validity + (R,) local flows (clamped to
    [0, F)) -> (R, D) f32: the explicit history gather, then
    :func:`derive_ref` computed in ``dtype``; ``mask`` zeroes masked-out
    rows."""
    lf = torch.clamp(local_flow.to(torch.int64), 0, memory.shape[0] - 1)
    out = derive_ref(memory[lf], entry_valid[lf], cfg, dtype)
    if mask is not None:
        out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out
