"""Feature enrichment — the collector's derived-feature stage (§III-C).

From the seven Table-I registers of each history entry: per-entry means,
variances, std-devs, coefficients of variation and skewness of IAT and
packet size, volume and rate terms (18 features); then, per flow, the
newest entry's features, the window mean and two-pass std over the
valid entries, newest-minus-mean deltas, the valid count and the largest
hist_idx — 74 features, zero-padded to ``derived_dim``. This module is
the plain PyTorch oracle; ``csrc/derive_block.cuh`` is the same math in
the fused CUDA kernel.
"""
from __future__ import annotations

import torch

from repro_torch import u32 as U
from repro_torch.configs.base import DFAConfig
from repro_torch.core import wire as WIRE

EPS = 1e-6
PER_ENTRY = 18


def entry_features(stats) -> torch.Tensor:
    """(..., 7) u32 Table-I registers -> (..., 18) f32 derived features."""
    s = U.wide(stats).to(torch.float32)
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


def derive_ref(memory_entries, entry_valid, cfg: DFAConfig) -> torch.Tensor:
    """(F, H, 16) u32 + (F, H) bool -> (F, derived_dim) f32."""
    wf = WIRE.resolve(cfg)
    stats = memory_entries[..., wf.payload_stats_slice]
    hist_idx = wf.payload_hist.extract(memory_entries)
    feats = entry_features(stats)                        # (F, H, 18)
    vmask = entry_valid.to(torch.float32)[..., None]
    feats = feats * vmask
    nvalid = torch.clamp(entry_valid.sum(-1, keepdim=True), min=1
                         ).to(torch.float32)
    # newest entry = first index of the largest valid packet count
    count = torch.where(entry_valid, U.wide(stats[..., 0]), 0)
    newest = torch.argmax(count, dim=-1)
    newest_f = torch.gather(
        feats, 1, newest[:, None, None].expand(-1, 1, PER_ENTRY))[:, 0]
    mean_w = feats.sum(1) / nvalid
    dev = (feats - mean_w[:, None, :]) * vmask           # two-pass variance
    std_w = torch.sqrt((dev * dev).sum(1) / nvalid)
    delta = newest_f - mean_w
    maxhist = torch.where(entry_valid, hist_idx.to(torch.float32),
                          0.0).amax(-1, keepdim=True)
    out = torch.cat([newest_f, mean_w, std_w, delta, nvalid, maxhist],
                    dim=-1)
    D = out.shape[-1]
    if D < cfg.derived_dim:
        out = torch.nn.functional.pad(out, (0, cfg.derived_dim - D))
    return out[:, :cfg.derived_dim]


def enrich_history(memory, entry_valid, local_flow, cfg: DFAConfig,
                   mask=None, backend=None) -> torch.Tensor:
    """Fused gather + derivation through the gather_enrich family:
    (F, H, 16) ring + (F, H) validity + (R,) local flows -> (R, D) f32.
    ``mask`` zeroes masked-out rows."""
    from repro_torch.kernels.gather_enrich.ops import gather_enrich
    out = gather_enrich(memory, entry_valid, local_flow, cfg,
                        backend=backend)
    if mask is not None:
        out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out
