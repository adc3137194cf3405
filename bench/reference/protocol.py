"""DFA wire formats (paper Figs 2 and 4) — pack/unpack over the schema.

Reports (14 words) and payloads (16 words = 64 B) travel as int32 bit
patterns; the unpackers return widened int64 field values
(``u32``). Layout, checksum coverage and every field position
come from :mod:`wire`.

The checksum is the reference's position-dependent rotate-then-xor fold:
each covered word is rotated left by its payload position before the
xor, so equal corruption masks on two words do not cancel.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from . import u32 as U
from . import wire as WIRE

PAYLOAD_WORDS = WIRE.V1.payload_words


def covered_positions(wire: WIRE.WireFormat, device) -> torch.Tensor:
    """The checksum's covered word positions (int64) on ``device``, made
    there once per (wire, device): a pageable host -> device copy on
    every pack and check would make the host wait for the device each
    time. Callers only read it."""
    return _covered_positions(wire, torch.device(device))


@functools.lru_cache(maxsize=None)
def _covered_positions(wire: WIRE.WireFormat, device: torch.device):
    return torch.tensor(wire.csum_covered, dtype=torch.int64, device=device)


def _rotl32(w: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotate-left each u32 (widened) by k bits (k mod 32)."""
    k = k % 32
    return ((w << k) | (w >> ((32 - k) % 32))) & U.MASK


def xor_checksum(words: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """XOR over the last axis of rotl(word_i, pos_i) -> widened (...,)."""
    w = U.wide(words)
    if positions is None:
        positions = torch.arange(words.shape[-1], device=words.device)
    rot = _rotl32(w, positions.to(torch.int64))
    out = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
    for i in range(w.shape[-1]):
        out = out ^ rot[..., i]
    return out


def pack_dta_report(flow_id, reporter_id, seq, stats, five_tuple,
                    wire: WIRE.WireFormat = WIRE.V1) -> torch.Tensor:
    """-> (..., report_words) int32 bit patterns."""
    meta = wire.pack_report_meta(reporter_id, seq)
    return U.narrow(torch.cat([U.wide(flow_id)[..., None], meta[..., None],
                               U.wide(stats), U.wide(five_tuple)], dim=-1))


def unpack_dta_report(r: torch.Tensor, wire: WIRE.WireFormat = WIRE.V1
                      ) -> Dict[str, torch.Tensor]:
    return {
        "flow_id": U.wide(r[..., wire.report_flow_word]),
        "reporter_id": wire.report_reporter.extract(r),
        "seq": wire.report_seq.extract(r),
        "stats": U.wide(r[..., wire.report_stats_slice]),
        "five_tuple": U.wide(r[..., wire.report_tuple_slice]),
    }


def pack_rocev2_payload(rep: Dict[str, torch.Tensor], hist_idx,
                        wire: WIRE.WireFormat = WIRE.V1) -> torch.Tensor:
    """Translator: DTA report fields + history index -> 64 B payload
    (int32 bit patterns)."""
    meta = wire.payload_meta_words(rep["reporter_id"], rep["seq"], hist_idx)
    body = torch.cat([U.wide(rep["flow_id"])[..., None],
                      U.wide(rep["stats"]), U.wide(rep["five_tuple"]),
                      meta[wire.payload_meta_word][..., None]], dim=-1)
    tail = meta[wire.payload_words - 1]
    covered = torch.cat([body, tail[..., None]], dim=-1)
    csum = xor_checksum(covered, covered_positions(wire, body.device))
    return U.narrow(torch.cat([body, csum[..., None], tail[..., None]],
                              dim=-1))


def unpack_payload(p: torch.Tensor, wire: WIRE.WireFormat = WIRE.V1
                   ) -> Dict[str, torch.Tensor]:
    return {
        "flow_id": U.wide(p[..., 0]),
        "stats": U.wide(p[..., wire.payload_stats_slice]),
        "five_tuple": U.wide(p[..., wire.payload_tuple_slice]),
        "reporter_id": wire.payload_reporter.extract(p),
        "seq": wire.payload_seq.extract(p),
        "hist_idx": wire.payload_hist.extract(p),
        "checksum": U.wide(p[..., wire.csum_word]),
    }


def payload_valid(p: torch.Tensor, wire: WIRE.WireFormat = WIRE.V1
                  ) -> torch.Tensor:
    """Collector-side integrity check (Fig 4 checksum) -> bool (...,)."""
    pos = covered_positions(wire, p.device)
    return xor_checksum(p[..., pos], pos) == U.wide(p[..., wire.csum_word])
