"""The comparison that decides ``correct``: the program's outputs and state
against the plain reference's, period by period.

Four numbers are compared, each against its limit in ``limits/<cell>.json``:

* ``words_differing`` — integer words that differ: every period's eight
  counters, the sampled periods' flow ids and masks, the non-finite
  features and logits (bit for bit), and after the last period the whole
  state (reporter registers, keys, ``last_ts``, ``last_report``,
  activity, seq and collisions; the translator's history counters; the
  collector ring, its validity, ``last_seq`` and its counters). Exact:
  limit 0.
* ``feature_gap`` — over the sampled periods' rows, the largest
  ``|program - reference|`` of one feature over that feature's own scale
  (:func:`feature_scale`): its reference value (at least 1), and for the
  window's mean, std and newest-minus-mean of a per-entry feature the
  largest of the newest entry's value, the mean and the std, the
  operands whose rounding they carry. A count, ``nvalid``, ``maxhist`` or a
  ``log1p`` term is held to its own size, not to the row's largest.
* ``logit_gap`` — the program's logits against the reference's logits
  from the reference's own features, over the masked rows but those
  :func:`ill_conditioned` leaves out: rows where a window feature that
  lies within rounding of zero beside its operands differs by rounding,
  so that ``log1p`` of it swings by O(1) on one ulp of summation order.
* ``head_gap`` — the program's logits against the reference's head run
  on the program's own features, over every masked row, the left-out
  rows too.

The share of masked rows that ``logit_gap`` leaves out is reported beside
them (:meth:`Comparison.left_out_share`), not compared: a row leaves only
where its features pass ``feature_gap``, and ``head_gap`` still holds its
logits.

Readings accumulate on the device; :meth:`Comparison.readings` reads them
once, at the end.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

NUMBERS = ("words_differing", "feature_gap", "logit_gap", "head_gap")
METRIC_KEYS = ("reports_sent", "reports_recv", "bucket_drops", "misroutes",
               "collisions", "bad_checksum", "seq_anomalies", "lost_reports")
PER_ENTRY = 18      # features of one ring entry; the row holds the newest
                    # entry's, then the window's mean, std and newest - mean
LEFT_OUT = 1e-3     # a window feature whose log1p moves by more, inside
                    # the feature limit, leaves its row out of logit_gap


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's words as int64 values (bool as 0/1, f32 by its bits)."""
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    return t.to(torch.int64)


def words_differing(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape:
        return torch.tensor(max(a.numel(), b.numel()), dtype=torch.int64,
                            device=b.device)
    return (_bits(a.to(b.device)) != _bits(b)).sum()


def _finite(got: torch.Tensor, want: torch.Tensor):
    """(program, reference) as f64 with the non-finite entries zeroed,
    and the words whose non-finite values differ bit for bit."""
    got = got.to(want.device)
    odd = ~torch.isfinite(want) | ~torch.isfinite(got)
    bad = (odd & (got.view(torch.int32) != want.view(torch.int32))).sum()
    return (torch.where(odd, 0.0, got).double(),
            torch.where(odd, 0.0, want).double(), bad)


def _gap(g: torch.Tensor, w: torch.Tensor, scale: torch.Tensor):
    if not g.numel():
        return torch.zeros((), dtype=torch.float64, device=w.device)
    return ((g - w).abs() / scale).amax()


def row_gap(got: torch.Tensor, want: torch.Tensor):
    """(largest row-scaled gap over the finite entries, words whose
    non-finite values differ bit for bit); for logits."""
    g, w, bad = _finite(got, want)
    return _gap(g, w, w.abs().amax(-1, keepdim=True).clamp(min=1.0)), bad


def feature_scale(want: torch.Tensor) -> torch.Tensor:
    """(R, D) reference features -> (R, D) scale of each: its magnitude,
    at least 1; in the window's mean, std and newest - mean of per-entry
    feature j, at least the largest magnitude of the newest entry's
    feature j, its mean and its std."""
    w = want.abs()
    scale = w.clamp(min=1.0)
    R, D, P = w.shape[0], w.shape[-1], PER_ENTRY
    if D <= P:
        return scale
    blocks = torch.nn.functional.pad(w[:, :4 * P], (0, max(0, 4 * P - D)))
    g = blocks.reshape(R, 4, P)[:, :3].amax(1).clamp(min=1.0)    # (R, P)
    win = g.repeat(1, 3)[:, :min(D, 4 * P) - P]
    scale[:, P:4 * P] = torch.maximum(scale[:, P:4 * P], win)
    return scale


def ill_conditioned(got: torch.Tensor, want: torch.Tensor,
                    limit: float) -> torch.Tensor:
    """(R, D) program and reference features -> (R,) rows whose logits
    the feature limit does not pin: a window feature (mean, std or newest
    - mean) within ``limit`` of its scale whose ``log1p`` (the head's
    input) still moves by more than ``LEFT_OUT``. Such a value lies within
    rounding of zero beside its operands, and summation order alone
    picks it."""
    P, D = PER_ENTRY, want.shape[-1]
    if D <= P:
        return torch.zeros(want.shape[0], dtype=torch.bool,
                           device=want.device)
    win = slice(P, min(D, 4 * P))
    g, w = got[:, win].double(), want[:, win].double()
    scale = feature_scale(want)[:, win].double()
    moved = (torch.log1p(g.abs()) - torch.log1p(w.abs())).abs()
    return (((g - w).abs() <= limit * scale) & (moved > LEFT_OUT)).any(-1)


class Comparison:
    """Accumulates the readings over a run's periods."""

    def __init__(self, n_periods: int, device, head=None):
        self.device = torch.device(device)
        self.head = head
        z = torch.zeros((), dtype=torch.int64, device=self.device)
        self.words = z.clone()
        self.rows, self.left_out = z.clone(), z.clone()
        f = torch.zeros((), dtype=torch.float64, device=self.device)
        self.feature, self.logit, self.head_ = f, f.clone(), f.clone()
        self.period_bad = torch.zeros(n_periods, dtype=torch.int64,
                                      device=self.device)

    def metrics(self, k: int, prog: Dict[str, torch.Tensor],
                ref: Dict[str, torch.Tensor]) -> None:
        """Period ``k``'s counters, program against reference."""
        bad = sum(words_differing(torch.as_tensor(prog[m]).reshape(()),
                                  ref[m].reshape(())) for m in METRIC_KEYS)
        self.words += bad
        self.period_bad[k] += bad

    def outputs(self, k: int, prog, ref, limits: Dict[str, float]) -> None:
        """Period ``k``'s outputs: ``prog`` (enriched, flow_ids, mask,
        preds) against the reference's ``Outputs``."""
        enriched, flow_ids, mask, preds = prog
        bad = words_differing(flow_ids, ref.flow_ids) \
            + words_differing(mask, ref.mask)
        g, w, fbad = _finite(enriched, ref.enriched)
        fgap = _gap(g, w, feature_scale(w))
        bad = bad + fbad
        lgap, hgap = torch.zeros_like(fgap), torch.zeros_like(fgap)
        if ref.preds is not None:
            if preds is None:
                bad = bad + ref.preds.numel()
            else:
                from bench.reference.period import head_logits
                preds = preds.to(ref.preds.device)
                keep = ref.mask & ~ill_conditioned(
                    g, w, limits["feature_gap"])
                lgap, lbad = row_gap(preds[keep], ref.preds[keep])
                want = head_logits(enriched.to(ref.preds.device), self.head)
                want = torch.where(ref.mask[:, None], want,
                                   torch.zeros_like(want))
                hgap, hbad = row_gap(preds, want)
                bad = bad + lbad + hbad
                self.rows += ref.mask.sum()
                self.left_out += (ref.mask & ~keep).sum()
        self.words += bad
        self.feature = torch.maximum(self.feature, fgap)
        self.logit = torch.maximum(self.logit, lgap)
        self.head_ = torch.maximum(self.head_, hgap)
        self.period_bad[k] += bad + (fgap > limits["feature_gap"]) \
            + (lgap > limits["logit_gap"]) + (hgap > limits["head_gap"])

    def state(self, prog, ref) -> None:
        """The state after the last period, every field of every table; a
        difference counts against the last period."""
        bad = sum(words_differing(getattr(getattr(prog, g), f),
                                  getattr(getattr(ref, g), f))
                  for g in ("reporter", "translator", "collector")
                  for f in getattr(ref, g)._fields)
        self.words += bad
        self.period_bad[-1] += bad

    def readings(self) -> Dict[str, float]:
        return {"words_differing": int(self.words),
                "feature_gap": float(self.feature),
                "logit_gap": float(self.logit),
                "head_gap": float(self.head_)}

    def left_out_share(self) -> float:
        """The share of the compared masked rows ``logit_gap`` left out."""
        rows = int(self.rows)
        return int(self.left_out) / rows if rows else 0.0

    def failed_periods(self) -> int:
        return int((self.period_bad > 0).sum())


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(readings[k] <= limits[k] for k in NUMBERS)


def report_lines(readings: Dict[str, float], limits: Dict[str, float]):
    """One line per number compared, with its limit."""
    return [f"check {k} {readings[k]!r} limit {limits[k]!r}"
            for k in NUMBERS]


def as_result(readings, limits) -> Dict[str, Dict[str, Optional[float]]]:
    return {k: {"value": readings[k], "limit": limits[k]} for k in NUMBERS}
