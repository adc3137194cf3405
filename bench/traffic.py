"""The one traffic generator: a traffic mix's parameters (a JSON file under
``traffic/``) and ``--seed`` -> a stacked trace on the device.

Per port, ``flows_per_port`` flows with five-tuples in the port's own
source subnet (so a flow enters through one port), heavy-tailed rates
(Pareto, clipped) and a TCP/UDP mix; per period and port,
``events_per_port`` packets drawn in proportion to the flows' rates,
with uniform timestamps in the period's window (sorted per port) and
bimodal sizes. Everything is drawn on ``device`` from one
``torch.Generator`` seeded with ``seed``, in a few large calls: the same
seed gives the same trace on the same device.

Layout: the period's events are port-major. ``ts`` / ``size`` (T, P*E)
and ``five_tuple`` (T, P*E, 5) are u32 words as int32 bit patterns,
``valid`` (T, P*E) bool; ``nows`` (T,) int64 is each period's end.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_MASK = 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 holding their bits."""
    return (((x & _MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def make_trace(mix: Dict, n_ports: int, seed: int, device
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    P, T = int(n_ports), int(mix["trace_periods"])
    E, F = int(mix["events_per_port"]), int(mix["flows_per_port"])
    period = int(mix["period_us"])

    def ints(lo, hi, shape):
        return torch.randint(int(lo), int(hi), shape, generator=g,
                             device=device, dtype=torch.int64)

    def unif(shape, dtype=torch.float64):
        return torch.rand(shape, generator=g, device=device, dtype=dtype)

    # flows: (P, F)
    span = int(mix["src_span_per_port"])
    port = torch.arange(P, device=device, dtype=torch.int64)[:, None]
    src = int(mix["src_base"]) + port * span + ints(0, span, (P, F))
    dst = ints(*mix["dst"], (P, F))
    sport = ints(*mix["sport"], (P, F))
    dports = torch.tensor(mix["dports"], dtype=torch.int64, device=device)
    dport = dports[ints(0, len(mix["dports"]), (P, F))]
    proto = torch.where(unif((P, F)) < float(mix["tcp_share"]), 6, 17)
    five = _i32(torch.stack([src, dst, (sport << 16) | dport, proto,
                             torch.zeros_like(src)], dim=-1))  # (P, F, 5)
    r = mix["rate"]
    lomax = (1.0 - unif((P, F))) ** (-1.0 / float(r["pareto_shape"]))
    rate = torch.clamp(lomax * float(r["scale"]), float(r["min"]),
                       float(r["max"]))
    cdf = torch.cumsum(rate, dim=1)
    cdf = cdf / cdf[:, -1:]

    # events: (T, P, E), drawn in proportion to the flows' rates
    pick = torch.searchsorted(cdf.contiguous(),
                              unif((P, T * E)).contiguous())
    pick = torch.clamp(pick, max=F - 1).view(P, T, E).transpose(0, 1)
    t0 = torch.arange(T, device=device, dtype=torch.int64)[:, None, None] \
        * period
    ts = torch.sort(ints(0, period, (T, P, E)), dim=-1).values + t0
    small = unif((T, P, E), torch.float32) < float(mix["small_share"])
    size = torch.where(small, ints(*mix["small_bytes"], (T, P, E)),
                       ints(*mix["large_bytes"], (T, P, E)))
    five_ev = five[port.view(1, P, 1).expand(T, P, E), pick]  # (T, P, E, 5)
    events = {"ts": _i32(ts).reshape(T, P * E),
              "size": _i32(size).reshape(T, P * E),
              "five_tuple": five_ev.reshape(T, P * E, 5),
              "valid": torch.ones(T, P * E, dtype=torch.bool,
                                  device=device)}
    nows = (torch.arange(1, T + 1, device=device, dtype=torch.int64)
            * period) & _MASK
    return events, nows
