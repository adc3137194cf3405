"""Versioned wire schema — the one source of truth for the report layout.

The port's copy of the reference schema: every bit position of the DTA
report (reporter -> translator) and of the RoCEv2 payload / collector
ring entry (translator -> collector, Fig 4) is a :class:`Field` (word,
shift, width) inside a registered :class:`WireFormat`.

``V1`` (default) is bit-faithful to the paper: reporter_id(8) << 24 |
seq(8) << 16 in report word 1 and payload word 13, hist_idx in the low
byte of payload word 13, word 15 a zero pad. ``V2`` widens reporter_id
and seq to 16 bits and moves hist_idx to payload word 15. The checksum
word (14) and its covered set (0-13 and 15) are the same in both.

Field helpers take u32 words as int32 bit patterns or widened int64
values (``repro_torch.u32``) and return widened int64 values.

Resolution of the active format: ``REPRO_WIRE_FORMAT`` env var (read
through ``repro_torch.configs.env``) > ``DFAConfig.wire_format`` >
``"v1"``; unknown names raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.configs import env as ENV

# flow-id value marking a padding row in emitted flow-id streams
PAD_FLOW_ID = 0xFFFFFFFF
# sort key of a padding row in the home translator's canonical order
PAD_SORT_KEY = 0xFFFFFFFF
ENV_VAR = ENV.WIRE_FORMAT.name


@dataclass(frozen=True)
class Field:
    """One packed field: ``word`` index, bit ``shift``, bit ``width``."""

    word: int
    shift: int
    width: int

    def __post_init__(self):
        if not (0 <= self.shift and self.shift + self.width <= 32):
            raise ValueError(f"field {self} does not fit a u32 word")

    @property
    def mask(self) -> int:
        return (1 << self.width) - 1

    @property
    def capacity(self) -> int:
        return 1 << self.width

    def get(self, word_val: torch.Tensor) -> torch.Tensor:
        """Extract from the raw word VALUE."""
        return (U.wide(word_val) >> self.shift) & self.mask

    def extract(self, words: torch.Tensor) -> torch.Tensor:
        """Extract from a ``(..., W)`` word ARRAY."""
        return self.get(words[..., self.word])

    def place(self, value: torch.Tensor) -> torch.Tensor:
        """The field's contribution to its word: ``(value & mask) << shift``."""
        return (U.wide(value) & self.mask) << self.shift

    def set_in(self, word_val: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
        """Repack: replace this field inside an existing word value."""
        keep = ~(self.mask << self.shift) & U.MASK
        return (U.wide(word_val) & keep) | self.place(value)


@dataclass(frozen=True)
class WireFormat:
    """A complete report + payload layout (all offsets/shifts/widths)."""

    name: str
    report_words: int
    report_reporter: Field
    report_seq: Field
    report_stats: Tuple[int, int]
    report_tuple: Tuple[int, int]
    payload_words: int
    payload_reporter: Field
    payload_seq: Field
    payload_hist: Field
    payload_stats: Tuple[int, int]
    payload_tuple: Tuple[int, int]
    csum_word: int
    csum_covered: Tuple[int, ...]

    def __post_init__(self):
        if self.report_reporter.width != self.payload_reporter.width:
            raise ValueError(f"{self.name}: reporter_id width differs "
                             "between report and payload")
        if self.report_seq.width != self.payload_seq.width:
            raise ValueError(f"{self.name}: seq width differs between "
                             "report and payload")
        if self.csum_word in self.csum_covered:
            raise ValueError(f"{self.name}: checksum word "
                             f"{self.csum_word} cannot cover itself")

    @property
    def report_flow_word(self) -> int:
        return 0

    @property
    def report_meta_word(self) -> int:
        return self.report_reporter.word

    @property
    def payload_meta_word(self) -> int:
        return self.payload_reporter.word

    @property
    def n_reporters(self) -> int:
        return self.report_reporter.capacity

    @property
    def reporter_width(self) -> int:
        return self.report_reporter.width

    @property
    def seq_width(self) -> int:
        return self.report_seq.width

    @property
    def seq_mask(self) -> int:
        return self.report_seq.mask

    @property
    def seq_dup_window(self) -> int:
        """§VI-B duplicate/replay window: 1/32 of the seq space."""
        return 1 << max(self.seq_width - 5, 0)

    @property
    def hist_counter_mask(self) -> int:
        return self.payload_hist.mask

    @property
    def report_stats_slice(self) -> slice:
        return slice(*self.report_stats)

    @property
    def report_tuple_slice(self) -> slice:
        return slice(*self.report_tuple)

    @property
    def payload_stats_slice(self) -> slice:
        return slice(*self.payload_stats)

    @property
    def payload_tuple_slice(self) -> slice:
        return slice(*self.payload_tuple)

    def pack_report_meta(self, reporter_id, seq) -> torch.Tensor:
        return self.report_reporter.place(reporter_id) \
            | self.report_seq.place(seq)

    def set_report_reporter(self, meta_word, reporter_id) -> torch.Tensor:
        return self.report_reporter.set_in(meta_word, reporter_id)

    def payload_meta_words(self, reporter_id, seq, hist_idx
                           ) -> Dict[int, torch.Tensor]:
        """Meta-word values keyed by payload word index (the tail pad
        word is always present: V1 leaves it zero, V2 packs hist_idx)."""
        zero = torch.zeros_like(U.wide(reporter_id))
        out = {self.payload_reporter.word: zero,
               self.payload_hist.word: zero,
               self.payload_words - 1: zero}
        for f, v in ((self.payload_reporter, reporter_id),
                     (self.payload_seq, seq),
                     (self.payload_hist, hist_idx)):
            out[f.word] = out[f.word] | f.place(v)
        return out


V1 = WireFormat(
    name="v1",
    report_words=14,
    report_reporter=Field(word=1, shift=24, width=8),
    report_seq=Field(word=1, shift=16, width=8),
    report_stats=(2, 9),
    report_tuple=(9, 14),
    payload_words=16,
    payload_reporter=Field(word=13, shift=24, width=8),
    payload_seq=Field(word=13, shift=16, width=8),
    payload_hist=Field(word=13, shift=0, width=8),
    payload_stats=(1, 8),
    payload_tuple=(8, 13),
    csum_word=14,
    csum_covered=tuple(range(14)) + (15,),
)

V2 = WireFormat(
    name="v2",
    report_words=14,
    report_reporter=Field(word=1, shift=16, width=16),
    report_seq=Field(word=1, shift=0, width=16),
    report_stats=(2, 9),
    report_tuple=(9, 14),
    payload_words=16,
    payload_reporter=Field(word=13, shift=16, width=16),
    payload_seq=Field(word=13, shift=0, width=16),
    payload_hist=Field(word=15, shift=0, width=8),
    payload_stats=(1, 8),
    payload_tuple=(8, 13),
    csum_word=14,
    csum_covered=tuple(range(14)) + (15,),
)

FORMATS: Dict[str, WireFormat] = {"v1": V1, "v2": V2}


def get(name: str) -> WireFormat:
    """Registry lookup; unknown names raise listing what exists."""
    if name not in FORMATS:
        raise ValueError(f"unknown wire format {name!r}; registered: "
                         f"{sorted(FORMATS)}")
    return FORMATS[name]


def resolve(cfg=None) -> WireFormat:
    """The active format: ``REPRO_WIRE_FORMAT`` > ``cfg.wire_format`` >
    ``"v1"``. Unset, empty or ``"auto"`` env values defer."""
    name = ENV.read_choice(ENV_VAR)
    if name is None:
        name = getattr(cfg, "wire_format", "v1") or "v1"
    return get(name)
