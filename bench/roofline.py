"""The least bytes a layer needs, from a cell's shapes and inputs, and the
least time they take at the chip's published memory bandwidth.

A layer's roofline share is that least time over the device time inside
the layer's spans, whatever kernels implement it. Each input byte is
counted read once and each output byte written once; where the work
depends on the data, the count is of what these inputs need (the slots
the period's events touch, the reports that arrived).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 SXM, published peak

# one packet event as the reporter reads it: ts, size (u32 each), the
# five-tuple (5 x u32) and its validity byte
EVENT_BYTES = 4 + 4 + 5 * 4 + 1
# one reporter slot's row: seven Table-I registers, last_ts, the stored
# five-tuple (u32 each) and the activity byte
SLOT_BYTES = 7 * 4 + 4 + 5 * 4 + 1
# one collector ring entry: the 64 B payload and its validity byte
ENTRY_BYTES = 64 + 1


def ingest_bytes(events: int, touched_slots: int) -> int:
    """``reporter.ingest`` of one block: the events read once, and the
    register rows of the slots they touch read and written once."""
    return events * EVENT_BYTES + 2 * touched_slots * SLOT_BYTES


def enrich_bytes(rows_valid: int, rows_out: int, history: int,
                 derived_dim: int, classes: int) -> int:
    """``enrich_half`` of one period: the ring entries of the reported
    flows read once (``history`` each), and every output row's features
    and logits (f32) written once."""
    return (rows_valid * history * ENTRY_BYTES
            + rows_out * (derived_dim + classes) * 4)


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def share_pct(n_bytes: float, device_seconds: float):
    """The roofline share in %, or None where no device time was seen."""
    if device_seconds <= 0:
        return None
    return 100.0 * least_seconds(n_bytes) / device_seconds
