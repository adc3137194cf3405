"""Scenario library for the multi-pod differential tests (the port's copy
of the reference's, numpy only, on the port's ``data.packets``; its
arrays equal the reference's for the same arguments).

Each scenario builds a MESH-INDEPENDENT traffic trace for a fixed set of
reporter PORTS: ``(events, nows)`` with events shaped
``(T, total_ports * events_per_port, ...)`` in port-major order. Because
the pipeline assigns ports to devices in pod-major contiguous ranges
(``total_ports / n_devices`` ports per device), the SAME global arrays
drive a ``(1, S)``, ``(2, S)`` or ``(4, S//2)`` mesh — only the sharding
of the leading event dim changes. That is the whole trick behind the
pod-count-invariance tests: one trace, three mesh factorizations,
bitwise-identical merged state.

Every generator is numpy + fixed seeds (stateless, reproducible); events
within one (port, period) block are in arrival order (the reporter
contract), which for the u32-wrap scenario means sorted by UNWRAPPED time
before the cast — exactly the stream a wrapped µs clock produces.

Scenarios (names are the registry keys):

  elephants_mice   heavy-tailed shared flow population seen by EVERY port
                   (maximally cross-pod: each flow's home pod sees reports
                   from all pods)
  port_local       each port observes only its own disjoint flow set (the
                   pod-local-heavy port assignment; homes still hash
                   anywhere, but ingest is disjoint)
  flow_churn       half of the flow population is replaced every period
                   (admission/eviction pressure on the Marina tables)
  collision_storm  flow count >> per-port table slots, forcing hash
                   collisions and resident-flow attribution
  bursty_iat       packets arrive in tight bursts with long gaps (stresses
                   the IAT moment registers and log* approximation)
  u32_wrap         the µs clock wraps 2^32 mid-trace (timestamps AND
                   ``nows`` wrap; wrap-safe IAT/due logic must hold on
                   every mesh identically)
  cross_pod_mix    half the ports share one global flow set, half are
                   port-local (the cross-pod-heavy vs pod-local-heavy
                   split on one trace)
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.data import packets as PK

PERIOD_US = 100_000


def _assemble(per_port: list, T: int, nows=None):
    """per_port: [port][period] -> event dict; -> stacked global arrays.

    Port-major concatenation per period matches the pod-major port ->
    device placement, so one array serves every mesh factorization."""
    keys = ("ts", "size", "five_tuple", "valid")
    events = {k: np.stack([
        np.concatenate([per_port[p][t][k] for p in range(len(per_port))])
        for t in range(T)]) for k in keys}
    if nows is None:
        nows = np.asarray([(t + 1) * PERIOD_US for t in range(T)],
                          np.uint32)
    return events, np.asarray(nows, np.uint32)


def _port_events(flows, port: int, t: int, n_events: int, seed: int):
    ev = PK.gen_events(flows, t0_us=t * PERIOD_US, window_us=PERIOD_US,
                       n_events=n_events,
                       seed=seed * 1_000_003 + t * 131 + port * 7919)
    return {k: ev[k] for k in ("ts", "size", "five_tuple", "valid")}


def elephants_mice(total_ports: int, events_per_port: int, T: int,
                   seed: int = 0):
    """3 elephants + a tail of mice, the SAME population on every port."""
    flows = PK.gen_flows(24, seed=seed)
    flows["rate"][:3] *= 50.0                      # elephants
    per_port = [[_port_events(flows, p, t, events_per_port, seed)
                 for t in range(T)] for p in range(total_ports)]
    return _assemble(per_port, T)


def port_local(total_ports: int, events_per_port: int, T: int,
               seed: int = 0):
    """Disjoint per-port flow sets (seeded per port, distinct subnets)."""
    per_port = []
    for p in range(total_ports):
        flows = PK.gen_flows(8, seed=seed * 677 + p + 1)
        # force disjoint identities across ports even under seed overlap
        flows["five_tuple"][:, 0] = (0x0A000000 + (p << 16)
                                     + np.arange(8)).astype(np.uint32)
        per_port.append([_port_events(flows, p, t, events_per_port, seed)
                         for t in range(T)])
    return _assemble(per_port, T)


def flow_churn(total_ports: int, events_per_port: int, T: int,
               seed: int = 0):
    """Half the population churns every period (new keys appear, old ones
    go quiet — admissions happen mid-trace on every port)."""
    per_port = [[] for _ in range(total_ports)]
    stable = PK.gen_flows(8, seed=seed)
    for t in range(T):
        fresh = PK.gen_flows(8, seed=seed * 31 + 1000 + t)
        fresh["five_tuple"][:, 1] = (0xC0A90000 + t * 256
                                     + np.arange(8)).astype(np.uint32)
        merged = {
            "five_tuple": np.concatenate([stable["five_tuple"],
                                          fresh["five_tuple"]]),
            "rate": np.concatenate([stable["rate"], fresh["rate"]]),
        }
        for p in range(total_ports):
            per_port[p].append(_port_events(merged, p, t, events_per_port,
                                            seed))
    return _assemble(per_port, T)


def collision_storm(total_ports: int, events_per_port: int, T: int,
                    seed: int = 0):
    """Far more distinct keys than table slots: admission races, stored-
    key mismatches and resident-flow attribution dominate."""
    flows = PK.gen_flows(512, seed=seed)
    per_port = [[_port_events(flows, p, t, events_per_port, seed)
                 for t in range(T)] for p in range(total_ports)]
    return _assemble(per_port, T)


def bursty_iat(total_ports: int, events_per_port: int, T: int,
               seed: int = 0):
    """Bursts: all packets of a period land in a handful of 200 µs
    windows, separated by silence (extreme IAT bimodality)."""
    flows = PK.gen_flows(12, seed=seed)
    rng = np.random.default_rng(seed + 17)
    per_port = []
    for p in range(total_ports):
        rows = []
        for t in range(T):
            ev = _port_events(flows, p, t, events_per_port, seed)
            bursts = rng.integers(0, PERIOD_US - 200, size=4)
            ev["ts"] = np.sort(
                t * PERIOD_US
                + bursts[rng.integers(0, 4, events_per_port)]
                + rng.integers(0, 200, events_per_port)).astype(np.uint32)
            rows.append(ev)
        per_port.append(rows)
    return _assemble(per_port, T)


def u32_wrap(total_ports: int, events_per_port: int, T: int,
             seed: int = 0):
    """The u32 µs clock wraps mid-trace: period t covers unwrapped time
    [W - 1.5 periods + t*period, ...), cast to u32. IAT, due-elapsed and
    last-report tracking must all survive the wrap identically on every
    mesh."""
    base = (1 << 32) - (3 * PERIOD_US) // 2        # wraps inside period 1
    flows = PK.gen_flows(10, seed=seed)
    rng = np.random.default_rng(seed + 29)
    per_port = []
    for p in range(total_ports):
        rows = []
        for t in range(T):
            ev = _port_events(flows, p, t, events_per_port, seed)
            unwrapped = base + t * PERIOD_US + np.sort(
                rng.integers(0, PERIOD_US, events_per_port))
            ev["ts"] = (unwrapped & 0xFFFFFFFF).astype(np.uint32)
            rows.append(ev)
        per_port.append(rows)
    nows = ((base + np.arange(1, T + 1, dtype=np.uint64) * PERIOD_US)
            & 0xFFFFFFFF).astype(np.uint32)
    return _assemble(per_port, T, nows=nows)


def cross_pod_mix(total_ports: int, events_per_port: int, T: int,
                  seed: int = 0):
    """First half of the ports share one global flow set (cross-pod
    heavy), second half are port-local (pod-local heavy)."""
    shared = PK.gen_flows(16, seed=seed + 3)
    per_port = []
    for p in range(total_ports):
        if p < total_ports // 2:
            flows = shared
        else:
            flows = PK.gen_flows(6, seed=seed * 131 + p)
            flows["five_tuple"][:, 0] = (0x0B000000 + (p << 12)
                                         + np.arange(6)).astype(np.uint32)
        per_port.append([_port_events(flows, p, t, events_per_port, seed)
                         for t in range(T)])
    return _assemble(per_port, T)


def wide_port_sweep(total_ports: int, events_per_port: int, T: int,
                    seed: int = 0):
    """Hundreds-of-ports scaling scenario (the wide wire-format regime):
    fully vectorized generation — every port owns two disjoint local
    flows and all ports share one global elephant, so one trace
    exercises both pod-local and maximally cross-pod homing. No
    per-port/per-flow python loops, so it stays cheap at the >256-port
    counts the V2 schema admits (where the other generators crawl)."""
    P, E = total_ports, events_per_port
    rng = np.random.default_rng(seed + 101)
    local_src = 0x0C000000 + np.arange(P, dtype=np.uint32)
    shared = np.asarray(
        [0x0D000001, 0xD0000001, (443 << 16) | 443, 6, 0], np.uint32)
    rows = {k: [] for k in ("ts", "size", "five_tuple", "valid")}
    for t in range(T):
        choice = rng.integers(0, 3, size=(P, E)).astype(np.uint32)
        is_local = choice < 2
        tup = np.zeros((P, E, 5), np.uint32)
        tup[..., 0] = np.where(is_local, local_src[:, None], shared[0])
        tup[..., 1] = np.where(
            is_local,
            0xC0000000 + 2 * np.arange(P, dtype=np.uint32)[:, None]
            + (choice & 1), shared[1])
        tup[..., 2] = np.where(is_local,
                               ((1000 + choice) << 16) | 2000, shared[2])
        tup[..., 3] = np.where(is_local, 17, shared[3])
        offs = np.sort(rng.integers(0, PERIOD_US, size=(P, E)), axis=1)
        rows["ts"].append(
            (t * PERIOD_US + offs).astype(np.uint32).reshape(P * E))
        rows["size"].append(
            rng.integers(64, 1500, size=(P, E)).astype(np.uint32)
            .reshape(P * E))
        rows["five_tuple"].append(tup.reshape(P * E, 5))
        rows["valid"].append(np.ones((P * E,), bool))
    events = {k: np.stack(v) for k, v in rows.items()}
    nows = np.asarray([(t + 1) * PERIOD_US for t in range(T)], np.uint32)
    return events, nows


SCENARIOS: Dict[str, Callable[..., Tuple[dict, np.ndarray]]] = {
    "elephants_mice": elephants_mice,
    "port_local": port_local,
    "flow_churn": flow_churn,
    "collision_storm": collision_storm,
    "bursty_iat": bursty_iat,
    "u32_wrap": u32_wrap,
    "cross_pod_mix": cross_pod_mix,
    "wide_port_sweep": wide_port_sweep,
}


def build(name: str, total_ports: int, events_per_port: int, T: int,
          seed: int = 0):
    """Registry entry point; raises KeyError listing known scenarios."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name](total_ports, events_per_port, T, seed=seed)
