"""Deterministic synthetic LM data (the port of ``repro.data.tokens``).

Stateless and step-keyed: ``batch_at(step, ...)`` is a pure function of
(seed, step, shape), so a resumed run sees exactly the batches the
uninterrupted run saw and there is no loader state to checkpoint.

The recipe is the reference's: tokens drawn from a Zipf unigram
(p(r) ∝ 1/r), and each sequence repeats an 8-gram motif, drawn from the
same unigram, on every position where ``(pos // 8) % 4 == 0`` (25 % of
positions), so the loss falls during a run. The draws come from a CPU
``torch.Generator`` seeded by a fixed mix of (seed, step); torch cannot
reproduce ``jax.random``'s threefry draws, so the two packages give
different tokens for the same seed (as ``data/faults.py``'s schedule
does). The differential tests feed the reference's batches to the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import torch_dtype

MOTIF = 8


def _generator(seed: int, step: int) -> torch.Generator:
    mix = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
           + 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator().manual_seed(mix)


def zipf_probs(vocab: int) -> torch.Tensor:
    r = torch.arange(1, vocab + 1, dtype=torch.float64)
    p = 1.0 / r
    return p / p.sum()


def batch_at(step: int, cfg: ModelConfig, batch: int, seq: int,
             seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """-> {"tokens", "targets"} int64 (batch, seq) and "mask" f32 ones,
    on ``device`` (the CPU by default)."""
    gen = _generator(seed, step)
    probs = zipf_probs(cfg.vocab_size)
    base = torch.multinomial(probs, batch * (seq + 1), replacement=True,
                             generator=gen).reshape(batch, seq + 1)
    motif = torch.multinomial(probs, batch * MOTIF, replacement=True,
                              generator=gen).reshape(batch, MOTIF)
    pos = torch.arange(seq + 1)
    use_motif = (pos // MOTIF) % 4 == 0
    toks = torch.where(use_motif[None, :], motif[:, pos % MOTIF], base)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "mask": torch.ones(batch, seq, dtype=torch.float32)}
    return {k: v.contiguous().to(device) for k, v in out.items()}


def add_modality_stub(batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                      step: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The stub frontends: for the vlm family ``batch["patches"]``, 0.02 x
    N(0, 1) patch embeddings (B, num_patches, d_model), for the encdec
    family ``batch["frames"]``, the same at (B, num_frames, d_model); in
    ``cfg.dtype`` on the tokens' device, from a CPU generator keyed by
    (seed + 7, step) as the reference keys its draw (the draws themselves
    differ, as the tokens' do). The dense, moe, hybrid and ssm families
    take the batch unchanged."""
    if cfg.family in ("vlm", "encdec"):
        name, n = (("patches", cfg.vision.num_patches) if cfg.family == "vlm"
                   else ("frames", cfg.encdec.num_frames))
        tokens = batch["tokens"]
        shape = (tokens.shape[0], n, cfg.d_model)
        draw = 0.02 * torch.randn(shape, generator=_generator(seed + 7, step))
        batch[name] = draw.to(device=tokens.device,
                              dtype=torch_dtype(cfg.dtype))
    return batch
