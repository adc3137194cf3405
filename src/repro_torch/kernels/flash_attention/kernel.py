"""Binding of the CUDA kernel ``flash_attention`` (csrc/flash_attention.cu).

The C entry holds three kernels: ``"pingpong"`` (bf16 at head dims 64
and 128), ``"wgmma"`` (bf16 at zamba2's 80 and MLA's (192, 128)) and
``"simt"`` (f32 and every other head dim). :func:`variant` chooses
between them from the dtype and head dims alone, before anything is built
or launched, and the entry refuses a tensor-core launch that breaks the
same rule.

The ``"pingpong"`` kernel walks a work plan that :func:`plan` makes on the
host: parts of (query head, 128-row query tile) items, each a range of
key tiles, dealt to persistent blocks. Where whole items would leave some
blocks with a tail of work the others lack, items are cut along the key
axis; each part of a cut item writes its unnormalised f32 output and its
softmax statistics to scratch, and the block that finishes the item's last
part merges them in part order (the kernel's design comment says why
nothing waits).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels.build import CudaKernel, check_args, ptr, stream_ptr
from repro_torch.kernels.flash_attention.ref import check_q_offset

# D and Dv up to this (kMaxHeadDim in csrc/flash_attention.cu); the Pallas
# function takes any head dim, and no config in the repo has one above it
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1, "pingpong": 2}
# (D, Dv) of the tensor-core instances in bf16: granite's, zamba2's, the
# larger families' and MLA's (the C entries' tensor_cores test holds the
# same)
WGMMA_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
# the subset the ping-pong kernel takes (the C entry's pingpong test):
# granite's and whisper's 64, the qwen / llama4 / llava 128
PINGPONG_HEAD_DIMS = ((64, 64), (128, 128))
# the kinds ``KERNEL.launches_by_kind`` counts (K7's counter too): a
# causal mask (at any query offset) or none
MASK_KINDS = ("causal", "full")

# the tensor-core kernels' query and key tile (kBQ = 2 x 64 and kWgBK in
# the source)
TILE = 128
# int32 fields of one part in a plan (kPartFields): bh, q0, kt0, kt1,
# part, parts of its item, its item's first partial, its item's counter
PART_FIELDS = 8
# cut items along the key axis when whole items leave the longest block
# more than this over the mean
SPLIT_SLACK = 1.05
# what a part costs the kernel beyond its key tiles, in key-tile steps (its
# epilogue, the turn that runs only S and the one that runs only P V): the
# planner's estimate, which evens out the blocks' part counts
# (tools/k6_trace.py times a part's stages on the card)
PART_COST = 2
# a cut item's pieces are at least this many key tiles (but for the last
# piece of the last item): fewer, larger pieces, fewer partials to merge
MIN_PIECE = 4


def partial_numel(Dv: int) -> int:
    """f32 elements of one part's partial (kPartialFloats): the two
    consumers' unnormalised outputs (128 rows x Dv) and, per thread, its
    rows' max and its columns' sum (2 x 128 x 4)."""
    return TILE * Dv + 2 * 128 * 4


def mask_kind(causal: bool) -> str:
    """The launch-count kind of a launch with this ``causal`` flag."""
    return MASK_KINDS[0] if causal else MASK_KINDS[1]


KERNEL = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
       ctypes.c_void_p] + [ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention/kernel.py:65",
    device_fns=("flash_attention_kernel", "flash_attention_wgmma_kernel",
                "flash_attention_pingpong_kernel"),
    variants=tuple(VARIANTS), kinds=MASK_KINDS)


def variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The kernel that runs for these inputs: ``"pingpong"`` (tensor
    cores, two consumer warpgroups taking turns, a balanced plan) for
    bf16 with (D, Dv) in :data:`PINGPONG_HEAD_DIMS`; ``"wgmma"`` (tensor
    cores) for bf16 at the rest of :data:`WGMMA_HEAD_DIMS` (zamba2's 80
    and MLA's D = 192, Dv = 128); ``"simt"`` for every other bf16 head dim
    and for f32, whose 2e-5 contract TF32 would break. Raises ValueError
    for another dtype or a head dim outside 1..MAX_HEAD_DIM."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{dtype}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv}: the kernel takes 1.."
                         f"{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and (D, Dv) in PINGPONG_HEAD_DIMS:
        return "pingpong"
    if dtype == torch.bfloat16 and (D, Dv) in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


Part = Tuple[int, int, int, int, int, int, int, int]


class Plan(NamedTuple):
    """A work plan: ``blocks[b]`` is block b's parts in the order it runs
    them, each ``(bh, q0, kt0, kt1, part, nparts, first, counter)``: key
    tiles kt0..kt1-1 of the item (query head bh, rows q0..q0+tile-1), part
    ``part`` of ``nparts``; a cut item (nparts > 1) owns partials first ..
    first + nparts - 1 and counter ``counter`` (-1 for a whole item)."""
    blocks: List[List[Part]]
    n_partials: int
    n_counters: int


def item_tiles(q0: int, Sq: int, Sk: int, causal: bool,
               tile: int = TILE, q_offset: int = 0) -> int:
    """Key tiles the item at query row q0 needs: all of Sk, or under the
    causal mask those up to the tile holding key q_offset + its last row
    (the last key its last row keeps)."""
    nk = -(-Sk // tile)
    if not causal:
        return nk
    return min(nk, (min(q0 + tile, Sq) - 1 + q_offset) // tile + 1)


def items(BH: int, Sq: int, Sk: int, causal: bool, tile: int = TILE,
          q_offset: int = 0) -> List[Tuple[int, int, int]]:
    """(bh, q0, key tiles) of every item, heaviest query tiles first."""
    nq = -(-Sq // tile)
    return [(bh, qt * tile,
             item_tiles(qt * tile, Sq, Sk, causal, tile, q_offset))
            for qt in reversed(range(nq)) for bh in range(BH)]


@functools.lru_cache(maxsize=256)
def plan(BH: int, Sq: int, Sk: int, causal: bool, sms: int,
         tile: int = TILE, q_offset: int = 0) -> Plan:
    """The ping-pong kernel's work plan for ``sms`` persistent blocks.
    Whole items, heaviest first, each to the block with the least work so
    far (work: key tiles plus :data:`PART_COST` a part; ties to the lowest
    block), over min(items, sms) blocks. Where the longest block would
    then walk more than :data:`SPLIT_SLACK` times the mean of key tiles
    (items of equal size that do not divide among the blocks, as at
    whisper's encoder), the blocks are G = min(key tiles, sms); the items
    of the whole rounds go round robin as whole items, and the last,
    partial round is laid end to end over the first g = min(G, T //
    MIN_PIECE) blocks (T its key tiles; only those g blocks when there is
    no whole round), block b taking its key-tile steps b T / g .. (b + 1)
    T / g - 1, an item cut where a block's share ends; this plan is taken
    where its longest block walks fewer key tiles than the whole items'
    longest. Deterministic: the same shape gives the same plan. Under
    the causal mask ``q_offset`` moves each item's last key tile (query
    row i keeps keys up to q_offset + i)."""
    its = items(BH, Sq, Sk, causal, tile, q_offset)
    G = min(len(its), sms)
    heap = [(0, b) for b in range(G)]
    blocks: List[List[Part]] = [[] for _ in range(G)]
    steps = [0] * G
    for bh, q0, n in its:
        work, b = heapq.heappop(heap)
        blocks[b].append((bh, q0, 0, n, 0, 1, -1, -1))
        steps[b] += n
        heapq.heappush(heap, (work + n + PART_COST, b))
    if max(steps) * G <= SPLIT_SLACK * sum(steps):
        return Plan(blocks, 0, 0)
    cut = _cut_plan(its, sms)
    return cut if max(block_steps(cut)) < max(steps) else Plan(blocks, 0, 0)


def _cut_plan(its: List[Tuple[int, int, int]], sms: int) -> Plan:
    """:func:`plan`'s cut plan of items ``its`` on ``sms`` blocks."""
    G = min(sum(n for _, _, n in its), sms)
    whole = len(its) // G * G
    tail = its[whole:]
    total = sum(n for _, _, n in tail)
    g = max(1, min(G, total // MIN_PIECE))
    if not whole:                       # no block without a part
        G = g
    blocks = [[] for _ in range(G)]
    for i, (bh, q0, n) in enumerate(its[:whole]):
        blocks[i % G].append((bh, q0, 0, n, 0, 1, -1, -1))
    bounds = [b * total // g for b in range(g + 1)]
    n_partials = n_counters = 0
    b = pos = 0
    for bh, q0, n in tail:
        pieces = []
        kt = 0
        while kt < n:
            while bounds[b + 1] <= pos:
                b += 1
            take = min(n - kt, bounds[b + 1] - pos)
            pieces.append((b, kt, kt + take))
            kt += take
            pos += take
        first = counter = -1
        if len(pieces) > 1:
            first, counter = n_partials, n_counters
            n_partials += len(pieces)
            n_counters += 1
        for p, (blk, k0, k1) in enumerate(pieces):
            blocks[blk].append((bh, q0, k0, k1, p, len(pieces), first,
                                counter))
    return Plan(blocks, n_partials, n_counters)


def block_steps(p: Plan) -> List[int]:
    """Key-tile steps each block of plan ``p`` walks."""
    return [sum(k1 - k0 for _, _, k0, k1, *_ in parts) for parts in p.blocks]


def plan_array(p: Plan) -> List[int]:
    """The plan as the kernel reads it: every part's PART_FIELDS int32,
    block after block, then the G + 1 offsets (in parts) of the blocks."""
    flat: List[int] = []
    offsets = [0]
    for parts in p.blocks:
        for part in parts:
            flat.extend(part)
        offsets.append(offsets[-1] + len(parts))
    return flat + offsets


@functools.lru_cache(maxsize=64)
def _device_plan(BH: int, Sq: int, Sk: int, causal: bool, q_offset: int,
                 dev: torch.device):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(BH, Sq, Sk, causal, sms, q_offset=q_offset)
    arr = torch.tensor(plan_array(p), dtype=torch.int32).to(dev)
    n_parts = sum(len(b) for b in p.blocks)
    return arr, n_parts, len(p.blocks), p.n_partials, p.n_counters


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         scale=None, force_variant=None, with_lse=False,
                         q_offset: int = 0):
    """Same contract as ``ref.flash_attention_ref``; f32 or bf16, head
    dims up to :data:`MAX_HEAD_DIM` (D != Dv allowed), any Sq and Sk.
    Under the causal mask query row i sits at position ``q_offset`` + i
    and keeps keys 0..q_offset + i (``q_offset`` >= 0; 0 is the TPU
    kernel's top-left mask; a negative offset raises ValueError, for the
    reason ``ref.check_q_offset`` gives, and ``ops.flash_attention``
    splits the rows it would leave key-less off before it calls this);
    every variant takes it, and an offset past Sk - 1 is passed as Sk,
    which keeps every key as well. The
    kernel is :func:`variant`'s; ``force_variant="simt"`` runs the SIMT
    kernel on any inputs and ``"wgmma"`` the one-schedule tensor-core
    kernel at any of :data:`WGMMA_HEAD_DIMS` (beside ``"pingpong"`` at
    (64, 64) and (128, 128), to time them); a forced variant the inputs do
    not qualify for raises, and nothing falls back. ``with_lse``: also
    return each row's logsumexp (BH, Sq) f32, as
    ``ref.flash_attention_lse_ref`` (the training forward keeps it for the
    backward); without it the kernel writes none."""
    BH, Sq, D = q.shape
    BHkv, Sk, Dv = k.shape[0], k.shape[1], v.shape[2]
    chosen = variant(q.dtype, D, Dv)
    if force_variant is not None:
        if force_variant not in VARIANTS:
            raise ValueError(f"unknown variant {force_variant!r}; expected "
                             f"one of {list(VARIANTS)}")
        if force_variant == "wgmma" and chosen == "simt":
            raise ValueError(f"the wgmma kernel takes bf16 with (D, Dv) in "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype} D={D} "
                             f"Dv={Dv}")
        if force_variant == "pingpong" and chosen != "pingpong":
            raise ValueError(f"the pingpong kernel takes bf16 with (D, Dv) "
                             f"in {PINGPONG_HEAD_DIMS}, got {q.dtype} D={D} "
                             f"Dv={Dv}")
        chosen = force_variant
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"q has {BH} heads; k/v have {BHkv} with group "
                         f"{group}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    q_offset = check_q_offset(q_offset)
    q_offset = min(q_offset, Sk) if causal else 0
    dev = q.device
    check_args(dev, (("q", q, q.dtype, (BH, Sq, D)),
                     ("k", k, q.dtype, (BHkv, Sk, D)),
                     ("v", v, q.dtype, (BHkv, Sk, Dv))))
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty(BH, Sq, Dv, dtype=q.dtype, device=dev)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=dev) if with_lse
           else None)
    arr = partials = counters = None
    n_parts = n_blocks = 0
    if chosen == "pingpong":
        arr, n_parts, n_blocks, n_partials, n_counters = _device_plan(
            BH, Sq, Sk, bool(causal), q_offset, dev)
        if n_counters:
            partials = torch.empty(n_partials * partial_numel(Dv),
                                   dtype=torch.float32, device=dev)
            counters = torch.zeros(n_counters, dtype=torch.int32,
                                   device=dev)
    opt = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), opt(lse),
                  BH, group, Sq, Sk, D, Dv, scale, int(causal), q_offset,
                  DTYPES[q.dtype], VARIANTS[chosen], opt(arr), n_parts,
                  n_blocks, opt(partials), opt(counters), stream_ptr(dev),
                  variant=chosen, kind=mask_kind(causal))
    return (out, lse) if with_lse else out
