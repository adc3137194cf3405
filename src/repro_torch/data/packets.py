"""Synthetic traffic-trace generator (the port's copy, numpy + torch).

Heavy-tailed flow rates (Pareto), bimodal packet sizes, a TCP/UDP mix;
stateless per (seed, step). The numpy generators are bit-identical to
the reference package's, so both systems see the same packets; the
batch functions hand the result over as torch tensors (u32 words as int32
bit patterns) on the requested device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import u32 as U


def gen_flows(n_flows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    five = np.zeros((n_flows, 5), np.uint32)
    five[:, 0] = rng.integers(0x0A000000, 0x0AFFFFFF, n_flows)  # 10.0.0.0/8
    five[:, 1] = rng.integers(0xC0A80000, 0xC0A8FFFF, n_flows)
    sport = rng.integers(1024, 65535, n_flows).astype(np.uint32)
    dport = rng.choice([80, 443, 8080, 53, 1935, 3478], n_flows).astype(
        np.uint32)
    five[:, 2] = (sport << 16) | dport
    five[:, 3] = rng.choice([6, 17], n_flows, p=[0.8, 0.2])     # tcp/udp
    rate = np.clip((rng.pareto(1.3, n_flows) + 1) * 50, 10, 5e4)
    return {"five_tuple": five, "rate": rate,
            "class": (rng.random(n_flows) * 8).astype(np.int32)}


def gen_events(flows: Dict[str, np.ndarray], t0_us: int, window_us: int,
               n_events: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """``n_events`` packets in [t0, t0+window), arrival intensity
    proportional to per-flow rate."""
    rng = np.random.default_rng(seed)
    p = flows["rate"] / flows["rate"].sum()
    fidx = rng.choice(len(p), size=n_events, p=p)
    ts = np.sort(t0_us + rng.integers(0, window_us, n_events)).astype(
        np.uint32)
    small = rng.random(n_events) < 0.45
    size = np.where(small, rng.integers(40, 120, n_events),
                    rng.integers(900, 1514, n_events)).astype(np.uint32)
    return {"ts": ts, "size": size,
            "five_tuple": flows["five_tuple"][fidx],
            "valid": np.ones(n_events, bool),
            "flow_idx": fidx}


def events_for_shards(flows, step: int, n_shards: int, events_per_shard: int,
                      window_us: int = 20_000, seed: int = 0):
    """Global event batch (numpy): each reporter shard's traffic slice."""
    out = [gen_events(flows, t0_us=step * window_us, window_us=window_us,
                      n_events=events_per_shard,
                      seed=seed * 100003 + step * 131 + s)
           for s in range(n_shards)]
    return {k: np.concatenate([o[k] for o in out])
            for k in ("ts", "size", "five_tuple", "valid")}


def events_to_torch(ev: Dict[str, np.ndarray], device=None
                    ) -> Dict[str, torch.Tensor]:
    """numpy event arrays -> torch (u32 words as int32 bit patterns)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if k == "valid" else U.from_numpy(v, device))
            for k, v in ev.items() if k in ("ts", "size", "five_tuple",
                                            "valid")}


def period_batches(n_shards: int, T: int, events_per_shard: int,
                   n_flows: int = 32, flow_seed: int = 0,
                   period_us: int = 100_000, window_us: int = 20_000,
                   device=None) -> Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]:
    """Stacked streaming input: (T, n_shards*E, ...) event tensors and
    (T,) int64 ``nows`` (u32 values) — what ``run_periods`` consumes."""
    flows = gen_flows(n_flows, seed=flow_seed)
    evs = [events_for_shards(flows, t, n_shards, events_per_shard,
                             window_us=window_us) for t in range(T)]
    events = events_to_torch({k: np.stack([e[k] for e in evs])
                              for k in evs[0]}, device)
    nows = torch.tensor([((t + 1) * period_us) & U.MASK for t in range(T)],
                        dtype=torch.int64, device=device)
    return events, nows


def synthetic_ring(flows: int, history: int, generator: torch.Generator,
                   valid_frac: float = 0.7
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A filled (flows, history, 16) collector ring (int32 bit patterns,
    on the CPU) whose Table-I words are the moment sums of plausible
    flows: 1-2000 packets, mean IAT 1-2000 µs, mean size 40-1500 B, power
    sums up to twice the mean's power, saturating at 2^32 - 1 like the
    reporter's registers; hist_idx (V1 word 13) in range; ``valid_frac``
    of the entries valid. Uniformly random words instead make some skew
    features so large that the window std overflows f32."""
    shape = (flows, history)
    g = generator
    n = torch.randint(1, 2001, shape, generator=g, dtype=torch.float64)
    cols = [n]
    for lo, hi in ((1, 2001), (40, 1501)):
        m = torch.randint(lo, hi, shape, generator=g, dtype=torch.float64)
        for p in (1, 2, 3):
            k = 1.0 + torch.rand(shape, generator=g, dtype=torch.float64)
            cols.append(n * m ** p * (k if p > 1 else 1.0))
    mem = torch.randint(0, 1 << 30, shape + (16,), generator=g,
                        dtype=torch.int64)
    mem[..., 1:8] = torch.stack(cols, -1).clamp(max=float(U.MASK)).to(
        torch.int64)
    mem[..., 13] = torch.arange(history)
    valid = torch.rand(shape, generator=g) < valid_frac
    return U.narrow(mem), valid
