"""Elastic pod loss and pod join (the port of ``repro.launch.elastic``).

A pod dies mid-stream; the system is rebuilt on the surviving
``(pods-1, shards_per_pod)`` mesh from the last snapshot, and ONLY the
dead pod's state moves:

    Heartbeat.dead_peers_by_pod() fires (whole pod stale / never beat)
        │
        ▼
    checkpoint.restore(snapshot_dir)      — last full DFAState + period
        │
        ▼
    survivor_config / survivor_system     — pods-1, same total port set,
        │                                   home_nodes minus the dead
        │                                   pod's node ids
        ▼
    rehome_state                          — survivors' blocks move bitwise
                                            (flow ids encode stable node
                                            ids); dead-node ring rows
                                            re-home by HRW over survivors

and a pod joins by the inverse (``join_config`` / ``join_system`` /
``expand_state``): every live row whose HRW winner over the grown roster
is a new node moves there, and nothing else does.

Why this is bitwise exact (``flow_home="rendezvous"`` only): HRW's
restriction property keeps every surviving key on its node, so its flow
id, ring row and history counter stay; the reporter state is per port
and the survivor mesh hosts the same total port set, so it transfers
unchanged; each ring entry stores its five-tuple (payload words 8-12), so
a moved row's new home is recomputed from the entry itself, word 0
becomes ``node_id * fps + slot`` and the checksum is refolded. The slot
hash does not depend on the roster, so a row keeps its slot.

What cannot move bitwise: a ring row whose live entries belong to keys
with different HRW homes (a slot collision). Such a row and its history
counter are one unit; ``cfg.rehome_collision_policy`` says what happens
("fail" raises with the count, "warn" warns and moves the row by its
first live entry's key).

The port has no mesh object: the survivor and grown systems are
``DFASystem(cfg', n_shards=...)`` emulated on one device, and
``devices=`` names that device (a torch device, or a sequence of one;
the system's own by default).

The state moves are vectorised on the state's device instead of the
reference's per-row host loop: the HRW winners of every entry of a
node's live rows at once, then one scatter per source node in ascending
node order — the reference's loop order, which decides which write wins
when two source rows land on one destination row.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import u32 as U
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.core import collector as COLL
from repro_torch.core import protocol as PROTO
from repro_torch.core import reporter as REP
from repro_torch.core import translator as TRANS
from repro_torch.core import wire as WIRE
from repro_torch.core.pipeline import DFAState, DFASystem
from repro_torch.distributed.monitor import Heartbeat

_SCALARS = ("bad_checksum", "seq_anomalies", "received", "lost_reports")


def one_device(devices, default) -> torch.device:
    """``devices`` as the one device a rebuilt system runs on: None gives
    ``default``; a device (or its name) or a sequence holding one is
    taken as it is. More than one raises: the port emulates the whole
    mesh on one device."""
    if devices is None:
        return torch.device(default)
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    devices = list(devices)
    if len(devices) != 1:
        raise ValueError(
            f"got {len(devices)} devices for the rebuilt system: the port "
            "emulates the whole (pod, shard) mesh on one device (one-card "
            "emulation), so pass one device")
    return torch.device(devices[0])


def _head_params(system: DFASystem):
    """The system's inference-head weights as numpy (None without a head),
    so a rebuilt system scores flows with the same head."""
    if system.head is None:
        return None
    return {k: p.detach().cpu().numpy()
            for k, p in system.head.named_parameters()}


def survivor_config(system: DFASystem, dead_pod: int):
    """The dead-pod-removed config: pods-1, SAME total port set (the
    survivor mesh absorbs the dead pod's ports), home_nodes minus the
    dead pod's node ids."""
    cfg = system.cfg
    if cfg.flow_home != "rendezvous":
        raise ValueError(
            f"elastic recovery needs flow_home='rendezvous', got "
            f"{cfg.flow_home!r}: the range-sharded 'hash' scheme renumbers "
            "every flow when the device count changes, so a pod loss would "
            "reshuffle the whole keyspace instead of ~1/pods of it")
    pods, S = system.mesh_pods, system.shards_per_pod
    if pods < 2:
        raise ValueError("cannot remove a pod from a single-pod mesh")
    if not 0 <= dead_pod < pods:
        raise ValueError(f"dead_pod={dead_pod} not in [0, {pods})")
    if system.total_ports % (pods - 1):
        raise ValueError(
            f"total ports {system.total_ports} do not spread over "
            f"{pods - 1} surviving pods")
    survivors = (system.home_nodes[:dead_pod * S]
                 + system.home_nodes[(dead_pod + 1) * S:])
    return dataclasses.replace(
        cfg, pods=pods - 1,
        ports_per_pod=system.total_ports // (pods - 1),
        home_nodes=survivors)


def survivor_system(system: DFASystem, dead_pod: int,
                    devices=None) -> DFASystem:
    """A DFASystem on the ``(pods-1, shards_per_pod)`` mesh, emulated on
    one device (``devices``; the system's own by default), with the
    system's head weights."""
    cfg = survivor_config(system, dead_pod)
    return DFASystem(cfg, device=one_device(devices, system.device),
                     infer_params=_head_params(system),
                     n_shards=cfg.pods * system.shards_per_pod)


class RehomeStats(NamedTuple):
    """What a membership-change state move actually did."""
    moved_rows: int               # ring rows that changed node
    unsplittable_collisions: int  # rows whose entries disagree on a home
    scanned_rows: int = 0         # live rows examined (= moved on shrink)


def _handle_unsplittable(count: int, policy: str, where: str) -> None:
    """The documented re-homing gap, surfaced instead of silently
    corrupting the ring: ``policy`` comes off
    ``DFAConfig.rehome_collision_policy`` ("fail" default / "warn")."""
    if count == 0:
        return
    msg = (f"{where}: {count} ring slot(s) hold entries from flows with "
           "different HRW homes — the shared row and history counter "
           "cannot be split during re-homing. Entries were moved by "
           "their FIRST live entry's key; the other flow's history is "
           "interleaved at the new home. Set "
           "rehome_collision_policy='warn' to accept this, or resize "
           "the ring (flows_per_shard) to make collisions rarer.")
    if policy == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    elif policy == "fail":
        raise RuntimeError(msg)
    else:
        raise ValueError(
            f"unknown rehome_collision_policy={policy!r} "
            "(expected 'fail' or 'warn')")


def _refold_checksum(payload: torch.Tensor,
                     wf: WIRE.WireFormat) -> torch.Tensor:
    """``payload`` (..., 16) int32 bit patterns with the checksum word
    recomputed over its covered words (after a word-0 rewrite)."""
    pos = PROTO.covered_positions(wf, payload.device)
    out = payload.clone()
    out[..., wf.csum_word] = U.narrow(PROTO.xor_checksum(payload[..., pos],
                                                         pos))
    return out


class _Rows(NamedTuple):
    """One source node's live ring rows and their HRW destinations."""
    rows: torch.Tensor        # (L,) int64 slots of the live rows
    pos: torch.Tensor         # (L,) int64 winner position of the first
    #                           live entry over the new roster
    unsplittable: int         # rows whose live entries disagree on pos


def _live_rows(memory, valid, nodes, wf) -> _Rows:
    """HRW winners over ``nodes`` of one node's (fps, H, 16) ring
    ``memory`` / (fps, H) ``valid``: every entry of every live row at
    once (each entry stores its own five-tuple); the row goes where its
    first live entry's key wins, and a row whose live entries name more
    than one winner is unsplittable."""
    rows = torch.nonzero(valid.any(dim=1)).reshape(-1)
    ev = valid[rows]
    kh = REP.hash_u32(memory[rows][:, :, wf.payload_tuple_slice])
    winners = TRANS.rendezvous_position(kh, nodes)           # (L, H)
    first = torch.argmax(ev.to(torch.int8), dim=1, keepdim=True)
    pos = winners.gather(1, first)
    split = ((winners != pos) & ev).any(dim=1)
    return _Rows(rows, pos.reshape(-1), int(split.sum()))


def _move(mem, valid, hist, src_mem, src_valid, src_hist, rows, pos,
          new_nodes, fps, wf) -> None:
    """Write one source node's rows ``rows`` (distinct slots) to
    ``pos * fps + slot`` of the new tables, in place: word 0 rewritten to
    the new flow id and the checksum refolded on the live entries, which
    alone overwrite the destination (``mem[dst, live] = pay[live]``);
    validity ORs in; the history counter travels with the row."""
    dst = pos * fps + rows
    ev = src_valid[rows]
    pay = src_mem[rows].clone()
    fid = U.mul(new_nodes[pos], fps) + rows                 # (L,)
    pay[:, :, 0] = U.narrow(fid)[:, None]
    pay = _refold_checksum(pay, wf)
    mem[dst] = torch.where(ev[:, :, None], pay, mem[dst])
    valid[dst] = valid[dst] | ev
    hist[dst] = src_hist[rows]


def _tables(state: DFAState, n_new: int, fps: int, wf) -> Dict:
    """Zeroed translator / collector tables of an ``n_new``-node mesh,
    on the state's device, in its dtypes."""
    c = state.collector
    return {"hist": state.translator.hist_counter.new_zeros(n_new * fps),
            "mem": c.memory.new_zeros((n_new * fps,) + c.memory.shape[1:]),
            "valid": c.entry_valid.new_zeros((n_new * fps,)
                                             + c.entry_valid.shape[1:]),
            "seq": c.last_seq.new_zeros((n_new, wf.n_reporters))}


def _new_state(state: DFAState, t: Dict, scalars: Dict) -> DFAState:
    """The moved state: the reporter copied unchanged (per port; the
    mesh keeps its port set), the new tables."""
    rep = type(state.reporter)(*(x.clone() for x in state.reporter))
    coll = COLL.CollectorState(
        memory=t["mem"], entry_valid=t["valid"],
        last_seq=t["seq"].reshape(-1), **scalars)
    return DFAState(rep, TRANS.TranslatorState(t["hist"]), coll)


def rehome_state(state: DFAState, old_system: DFASystem,
                 new_system: DFASystem, dead_pod: int
                 ) -> Tuple[DFAState, RehomeStats]:
    """Move a full-mesh DFAState onto the survivor roster, on the
    state's device; the result owns fresh tensors (no view of ``state``).

    Survivor node blocks copy bitwise to their new pod-major positions;
    the dead pod's live ring rows re-home via HRW over the survivor
    roster (the stored five-tuple is the key), with flow-id word 0
    rewritten and the checksum refolded. Per-device merge-only stats
    (``last_seq`` elementwise max, the scalar counters summed mod 2^32)
    fold the dead devices' values into survivor device 0.

    Unsplittable rows (live entries whose survivor homes disagree) are
    counted and surfaced via ``new_system.cfg.rehome_collision_policy``:
    "fail" raises with the count, "warn" moves the row by its first live
    entry's key and warns. Returns ``(new_state, RehomeStats)``.
    """
    wf = old_system.wire
    S = old_system.shards_per_pod
    fps = old_system.cfg.flows_per_shard
    old_nodes = list(old_system.home_nodes)
    new_nodes = list(new_system.home_nodes)
    dead_pos = list(range(dead_pod * S, (dead_pod + 1) * S))
    surv_pos = [i for i in range(len(old_nodes)) if i not in dead_pos]
    n_new = len(new_nodes)
    assert [old_nodes[i] for i in surv_pos] == new_nodes
    c = state.collector
    hist_old = state.translator.hist_counter
    old_seq = c.last_seq.reshape(len(old_nodes), wf.n_reporters)

    t = _tables(state, n_new, fps, wf)
    for new_i, old_i in enumerate(surv_pos):
        src = slice(old_i * fps, (old_i + 1) * fps)
        dst = slice(new_i * fps, (new_i + 1) * fps)
        t["hist"][dst] = hist_old[src]
        t["mem"][dst] = c.memory[src]
        t["valid"][dst] = c.entry_valid[src]
        t["seq"][new_i] = old_seq[old_i]

    nodes = torch.tensor(new_nodes, dtype=torch.int64,
                         device=c.memory.device)
    moved = unsplittable = 0
    for old_i in dead_pos:                  # ascending: the write order
        src = slice(old_i * fps, (old_i + 1) * fps)
        live = _live_rows(c.memory[src], c.entry_valid[src], nodes, wf)
        _move(t["mem"], t["valid"], t["hist"], c.memory[src],
              c.entry_valid[src], hist_old[src], live.rows, live.pos,
              nodes, fps, wf)
        moved += int(live.rows.numel())
        unsplittable += live.unsplittable
    _handle_unsplittable(unsplittable,
                         new_system.cfg.rehome_collision_policy,
                         f"rehome_state(dead_pod={dead_pod})")

    # merge-only per-device stats: the dead devices fold into survivor 0
    t["seq"][0] = U.narrow(U.wide(torch.cat(
        [t["seq"][:1], old_seq[dead_pos]])).amax(dim=0))
    scalars = {}
    for k in _SCALARS:
        old = getattr(c, k)
        v = old.new_zeros(n_new)
        v[:] = old[surv_pos]
        v[0] = U.narrow(U.wide(torch.cat([v[:1], old[dead_pos]])).sum())
        scalars[k] = v
    return (_new_state(state, t, scalars),
            RehomeStats(moved, unsplittable, moved))


def recover_from_snapshot(system: DFASystem, snapshot_dir: str,
                          dead_pod: int, devices=None,
                          step: Optional[int] = None
                          ) -> Tuple[DFASystem, DFAState, int]:
    """Full recovery: restore the last snapshot onto the survivor's
    device, rebuild on the survivor mesh, re-home the dead pod's flows.

    Returns ``(new_system, new_state, period)`` — resume by re-feeding
    the trace from ``period`` (the replay window). The move's
    :class:`RehomeStats` ride on ``new_system.last_rehome_stats``, and
    the host time of the restore and of the rebuild + re-home (µs) on
    ``new_system.last_recovery_us``."""
    device = one_device(devices, system.device)
    t0 = time.perf_counter()
    restored, period = CKPT.restore(snapshot_dir, step=step, device=device)
    t1 = time.perf_counter()
    new_system = survivor_system(system, dead_pod, devices=device)
    state, stats = rehome_state(restored, system, new_system, dead_pod)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    new_system.last_rehome_stats = stats
    new_system.last_recovery_us = {
        "restore": (t1 - t0) * 1e6,
        "rehome": (time.perf_counter() - t1) * 1e6}
    return new_system, state, int(period)


def whole_dead_pods(hb: Heartbeat) -> List[int]:
    """Pods whose EVERY registered process is stale or never beat.

    Requires ``hb.expected_peers`` (the roster is what makes a process
    that died before its first beat visible at all)."""
    expected = hb._expected()
    if not expected:
        return []
    stale = hb.dead_peers()
    per_pod: Dict[int, List[int]] = {}
    for idx, pod in expected.items():
        per_pod.setdefault(pod, []).append(idx)
    return sorted(pod for pod, procs in per_pod.items()
                  if all(i in stale for i in procs))


def maybe_recover(hb: Heartbeat, system: DFASystem, snapshot_dir: str,
                  devices=None, ignore_pods: Sequence[int] = ()
                  ) -> Optional[Tuple[DFASystem, DFAState, int]]:
    """The pod-loss trigger: if a whole pod is dead per the heartbeat
    roster, recover onto the survivor mesh; None when all pods live.

    ``ignore_pods``: pods ALREADY recovered from — a heartbeat can keep
    reporting a removed pod as dead (its processes never beat again), and
    recovering from the same loss twice would re-home state that already
    moved. A trip that only names ignored pods is a no-op."""
    dead = [d for d in whole_dead_pods(hb) if d not in set(ignore_pods)]
    if not dead:
        return None
    return recover_from_snapshot(system, snapshot_dir, dead[0],
                                 devices=devices)


# -- pod join (grow) -------------------------------------------------------

def join_config(system: DFASystem, new_nodes: Sequence[int]):
    """The pod-added config: pods+1, SAME total port set (each pod hosts
    fewer ports), home_nodes extended with the new pod's node ids.

    The new ids must sort strictly above the existing roster: the new pod
    appends at the pod-major END of the mesh, and ``rendezvous_position``
    requires a sorted roster for mesh-invariant tie-breaks."""
    cfg = system.cfg
    if cfg.flow_home != "rendezvous":
        raise ValueError(
            f"pod join needs flow_home='rendezvous', got "
            f"{cfg.flow_home!r}: the range-sharded 'hash' scheme "
            "renumbers every flow when the device count changes")
    pods, S = system.mesh_pods, system.shards_per_pod
    new_nodes = tuple(int(n) for n in new_nodes)
    if len(new_nodes) != S:
        raise ValueError(
            f"a joining pod contributes one node id per shard: got "
            f"{len(new_nodes)} ids for {S} shards_per_pod")
    if list(new_nodes) != sorted(set(new_nodes)):
        raise ValueError(f"new node ids {new_nodes} must be strictly "
                         "increasing")
    if system.home_nodes and min(new_nodes) <= max(system.home_nodes):
        raise ValueError(
            f"new node ids {new_nodes} must all exceed the current "
            f"roster maximum {max(system.home_nodes)} — the joining pod "
            "appends at the sorted end of the pod-major roster")
    if system.total_ports % (pods + 1):
        raise ValueError(
            f"total ports {system.total_ports} do not spread over "
            f"{pods + 1} pods")
    return dataclasses.replace(
        cfg, pods=pods + 1,
        ports_per_pod=system.total_ports // (pods + 1),
        home_nodes=tuple(system.home_nodes) + new_nodes)


def join_system(system: DFASystem, new_nodes: Sequence[int],
                devices=None) -> DFASystem:
    """A DFASystem on the ``(pods+1, shards_per_pod)`` mesh, emulated on
    one device (``devices``; the system's own by default)."""
    cfg = join_config(system, new_nodes)
    return DFASystem(cfg, device=one_device(devices, system.device),
                     infer_params=_head_params(system),
                     n_shards=cfg.pods * system.shards_per_pod)


def expand_state(state: DFAState, old_system: DFASystem,
                 new_system: DFASystem) -> Tuple[DFAState, RehomeStats]:
    """Move a DFAState onto the grown roster, on the state's device — the
    inverse of :func:`rehome_state`; the result owns fresh tensors.

    Adding nodes only moves the flows whose winner over the grown roster
    IS a new node. So every LIVE ring row of the existing devices is
    scored over the grown roster, and the rows that a new node wins move:
    word 0 rewritten to ``new_node * fps + slot``, checksum refolded,
    history counter travelling with the row, source row cleared. The
    reporter state transfers unchanged.

    Unsplittable rows (over every scanned row) are surfaced via
    ``rehome_collision_policy`` as in the shrink direction ("warn" keeps
    such a row where its first live entry's key says).
    """
    wf = old_system.wire
    fps = old_system.cfg.flows_per_shard
    old_nodes = list(old_system.home_nodes)
    new_nodes = list(new_system.home_nodes)
    n_old, n_new = len(old_nodes), len(new_nodes)
    assert new_nodes[:n_old] == old_nodes
    c = state.collector
    hist_old = state.translator.hist_counter

    t = _tables(state, n_new, fps, wf)
    # existing devices keep their pod-major positions: prefix copy
    t["hist"][:n_old * fps] = hist_old
    t["mem"][:n_old * fps] = c.memory
    t["valid"][:n_old * fps] = c.entry_valid
    t["seq"][:n_old] = c.last_seq.reshape(n_old, wf.n_reporters)

    nodes = torch.tensor(new_nodes, dtype=torch.int64,
                         device=c.memory.device)
    moved = scanned = unsplittable = 0
    for old_i in range(n_old):              # ascending: the write order
        src = slice(old_i * fps, (old_i + 1) * fps)
        live = _live_rows(c.memory[src], c.entry_valid[src], nodes, wf)
        scanned += int(live.rows.numel())
        unsplittable += live.unsplittable
        go = live.pos >= n_old              # a new node wins: the row moves
        rows, pos = live.rows[go], live.pos[go]
        _move(t["mem"], t["valid"], t["hist"], c.memory[src],
              c.entry_valid[src], hist_old[src], rows, pos, nodes, fps, wf)
        # clear the source: a clean larger-mesh run never wrote there
        at = old_i * fps + rows
        t["mem"][at] = 0
        t["valid"][at] = False
        t["hist"][at] = 0
        moved += int(rows.numel())
    _handle_unsplittable(unsplittable,
                         new_system.cfg.rehome_collision_policy,
                         f"expand_state(+{n_new - n_old} nodes)")

    scalars = {}
    for k in _SCALARS:
        old = getattr(c, k)
        v = old.new_zeros(n_new)
        v[:n_old] = old
        scalars[k] = v
    return (_new_state(state, t, scalars),
            RehomeStats(moved, unsplittable, scanned))
