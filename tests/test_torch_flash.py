"""The port's flash_attention family (K6's plain version and the model's
``chunked_attention``) against the JAX package on the CPU.

Inputs are drawn with numpy and handed to both packages. The Pallas
kernel runs in interpret mode, as ``tests/test_flash_kernel.py`` runs
it. Tolerances are that file's: 2e-5 in f32, 2e-2 in bf16 (the two
frameworks round p to bf16 at the same point but sum in another order).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import attention as TA

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, by JAX, and carried across exactly through f32)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the five cases of tests/test_flash_kernel.py
CASES = [
    # BH, Sq, Sk, D, Dv, group, bq, bk, dtype, causal
    (4, 64, 64, 16, 16, 1, 16, 16, "float32", True),      # MHA
    (8, 64, 64, 16, 16, 4, 32, 16, "float32", True),      # GQA group=4
    (6, 48, 96, 8, 12, 3, 16, 32, "float32", True),       # Dv != D, Sq != Sk
    (4, 64, 64, 16, 16, 2, 16, 16, "bfloat16", True),     # bf16 io
    (2, 32, 32, 8, 8, 1, 16, 16, "float32", False),       # non-causal
]


@pytest.mark.parametrize("BH,Sq,Sk,D,Dv,group,bq,bk,dtype,causal", CASES)
def test_plain_version_matches_pallas_and_ref(rng, BH, Sq, Sk, D, Dv, group,
                                              bq, bk, dtype, causal):
    qj, qt = _both(rng.standard_normal((BH, Sq, D)), dtype)
    kj, kt = _both(rng.standard_normal((BH // group, Sk, D)), dtype)
    vj, vt = _both(rng.standard_normal((BH // group, Sk, Dv)), dtype)
    FK.KERNEL.launches = 0
    got = FA.flash_attention(qt, kt, vt, group=group, causal=causal)
    assert FK.KERNEL.launches == 0          # a CPU tensor runs the plain one
    assert got.dtype == TDT[dtype] and got.shape == (BH, Sq, Dv)
    pallas = flash_attention_pallas(qj, kj, vj, group=group, causal=causal,
                                    bq=bq, bk=bk)
    ref = flash_attention_ref(qj, kj, vj, group=group, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (pallas, ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_plain_version_matches_pallas_at_the_mla_head_dims(rng, dtype,
                                                           causal):
    """MLA's prefill shape, D = 128 + 64 = 192 and Dv = 128 (group 1),
    against the Pallas function in interpret mode (its BlockSpecs span the
    whole D and Dv) at Sq = Sk = 128 with 64-row tiles. On the card bf16
    runs the wgmma kernel and f32 the SIMT one."""
    BH, S, D, Dv = 2, 128, 192, 128
    qj, qt = _both(rng.standard_normal((BH, S, D)), dtype)
    kj, kt = _both(rng.standard_normal((BH, S, D)), dtype)
    vj, vt = _both(rng.standard_normal((BH, S, Dv)), dtype)
    scale = D ** -0.5
    got = FA.flash_attention(qt, kt, vt, causal=causal, scale=scale)
    assert got.shape == (BH, S, Dv)
    assert FK.variant(qt.dtype, D, Dv) == ("wgmma" if dtype == "bfloat16"
                                           else "simt")
    want = flash_attention_pallas(qj, kj, vj, causal=causal, scale=scale,
                                  bq=64, bk=64)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KH", [(2, 64, 8, 4), (2, 64, 8, 2),
                                      (1, 40, 8, 2), (3, 40, 4, 2)])
def test_chunked_attention_matches_jax(rng, B, S, H, KH):
    """The model-side wrapper (B,S,H,D) -> kernel layout -> back against
    the reference's pure-JAX flash path, at group 2 and 4; S = 40 is not
    a multiple of any tile."""
    D = 16
    qj, qt = _both(rng.standard_normal((B, S, H, D)), "float32")
    kj, kt = _both(rng.standard_normal((B, S, KH, D)), "float32")
    vj, vt = _both(rng.standard_normal((B, S, KH, D)), "float32")
    want = JA.chunked_attention(qj, kj, vj, q_chunk=16, kv_chunk=32)
    got = TA.chunked_attention(qt, kt, vt)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_chunked_attention_negative_offset_matches_jax(rng):
    """At query offsets -1 and -8 (the first 1 and all 8 rows keep no key,
    and get the mean of v over all keys from the reference's finite mask)
    the model-side wrapper agrees with the reference's forward within
    2e-5; the gradients are held in tests/test_torch_attention_offset.py."""
    B, S, H, KH, D = 1, 8, 2, 1, 4
    qj, qt = _both(rng.standard_normal((B, S, H, D)), "float32")
    kj, kt = _both(rng.standard_normal((B, S, KH, D)), "float32")
    vj, vt = _both(rng.standard_normal((B, S, KH, D)), "float32")
    for offset in (-1, -8):
        want = JA.chunked_attention(qj, kj, vj, q_offset=offset, q_chunk=4,
                                    kv_chunk=4)
        got = TA.chunked_attention(qt, kt, vt, q_offset=offset)
        assert got.shape == (B, S, H, D)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


def test_flash_decode_matches_jax(rng, mesh):
    """One decode step against a partly filled cache, on the (1, 1) mesh
    (the reference's pmax/psum combine over one shard)."""
    B, S, H, KH, D = 3, 24, 4, 2, 16
    pos = np.array([0, 7, 23])
    qj, qt = _both(rng.standard_normal((B, H, D)), "float32")
    kcj, kct = _both(rng.standard_normal((B, S, KH, D)), "float32")
    vcj, vct = _both(rng.standard_normal((B, S, KH, D)), "float32")
    knj, knt = _both(rng.standard_normal((B, KH, D)), "float32")
    vnj, vnt = _both(rng.standard_normal((B, KH, D)), "float32")
    with mesh:
        oj, kj, vj = JA.flash_decode(qj, kcj, vcj, knj, vnj,
                                     jnp.asarray(pos, jnp.int32), mesh=mesh,
                                     seq_axes=("model",),
                                     batch_axes=("data",))
    ot, kt, vt = TA.flash_decode(qt, kct, vct, knt, vnt,
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(vt), _np(vj))


def test_kernel_wrapper_refuses_what_k6_does_not_take():
    """The binding's checks run before anything is built or launched."""
    q = torch.zeros(4, 8, 16)
    kv = torch.zeros(2, 8, 16)
    bad = [
        (dict(q=q.double(), k=kv.double(), v=kv.double(), group=2), "float32"),
        (dict(q=q, k=kv, v=kv, group=3), "heads"),
        (dict(q=torch.zeros(4, 8, 320), k=torch.zeros(2, 8, 320), v=kv,
              group=2), "head dims"),
        (dict(q=q, k=kv, v=kv, group=2), "contiguous"),      # CPU tensors
    ]
    for kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            FK.flash_attention_cuda(**kw)
    assert FK.KERNEL._fn is None and FK.KERNEL.launches == 0
    with pytest.raises(RuntimeError, match="backend 'cuda'"):
        FA.flash_attention(q, kv, kv, group=2, backend="cuda")


# kernel.variant: which of K6's three kernels a launch runs
VARIANT_CASES = [
    # dtype, D, Dv, variant
    (torch.bfloat16, 64, 64, "pingpong"),    # granite-3-2b's, whisper's
    (torch.bfloat16, 128, 128, "pingpong"),  # the larger families', llava's
    (torch.bfloat16, 80, 80, "wgmma"),       # zamba2-2.7b's head dim
    (torch.float32, 80, 80, "simt"),
    (torch.bfloat16, 64, 128, "simt"),       # Dv != D
    (torch.bfloat16, 128, 64, "simt"),
    (torch.bfloat16, 16, 16, "simt"),        # the REDUCED config
    (torch.bfloat16, 8, 12, "simt"),         # the tests' small dims
    (torch.bfloat16, 32, 32, "simt"),
    (torch.bfloat16, 96, 96, "simt"),
    (torch.float32, 64, 64, "simt"),         # f32 keeps its 2e-5 contract
    (torch.float32, 128, 128, "simt"),
    (torch.float32, 16, 16, "simt"),
    (torch.bfloat16, 192, 128, "wgmma"),     # deepseek-v3's MLA prefill
    # every other head dim past 128 runs SIMT, D != Dv among them
    (torch.float32, 192, 128, "simt"),
    (torch.bfloat16, 192, 64, "simt"),
    (torch.bfloat16, 192, 192, "simt"),
    (torch.bfloat16, 128, 192, "simt"),
    (torch.bfloat16, 160, 64, "simt"),
    (torch.bfloat16, 129, 129, "simt"),
    (torch.bfloat16, 256, 256, "simt"),
    (torch.bfloat16, 64, 160, "simt"),
    (torch.float32, 192, 64, "simt"),
]


@pytest.mark.parametrize("dtype,D,Dv,want", VARIANT_CASES)
def test_variant_rule(dtype, D, Dv, want):
    assert FK.variant(dtype, D, Dv) == want


@pytest.mark.parametrize("dtype,D,Dv", [(torch.bfloat16, 96, 96),
                                        (torch.float32, 80, 80),
                                        (torch.bfloat16, 80, 64)])
def test_forced_wgmma_refuses_what_the_rule_does_not_take(dtype, D, Dv):
    """K6 forced onto "wgmma" or "pingpong" outside the rule raises before
    anything is built or launched; zamba2's bf16 (80, 80) passes the
    wgmma rule, and bf16 (64, 64) and (128, 128) pass both (the wgmma
    kernel stays launchable there, to be timed beside the ping-pong one),
    and stop only at the CPU tensors. (80, 80) is not the ping-pong
    kernel's."""
    q, k = torch.zeros(4, 8, D, dtype=dtype), torch.zeros(2, 8, D,
                                                           dtype=dtype)
    v = torch.zeros(2, 8, Dv, dtype=dtype)
    with pytest.raises(ValueError, match="wgmma kernel takes bf16"):
        FK.flash_attention_cuda(q, k, v, group=2, force_variant="wgmma")
    with pytest.raises(ValueError, match="pingpong kernel takes bf16"):
        FK.flash_attention_cuda(q, k, v, group=2, force_variant="pingpong")
    for d, forces in ((80, ("wgmma",)), (64, ("wgmma", "pingpong")),
                      (128, ("wgmma", "pingpong"))):
        q, k = torch.zeros(4, 8, d, dtype=torch.bfloat16), torch.zeros(
            2, 8, d, dtype=torch.bfloat16)
        for force in forces:
            with pytest.raises(ValueError, match="contiguous"):
                FK.flash_attention_cuda(q, k, k, group=2,
                                        force_variant=force)
    q = torch.zeros(4, 8, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pingpong kernel takes bf16"):
        FK.flash_attention_cuda(q, q[:2], q[:2], group=2,
                                force_variant="pingpong")
    assert FK.KERNEL._fn is None and FK.KERNEL.launches == 0


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "flash_attention_bwd.cu"])
def test_c_entries_hold_the_variant_rule(source):
    """The (D, Dv) pairs of each C entry's ``tensor_cores`` test, its
    bf16-only condition and the wgmma instances it dispatches to are
    ``variant()``'s tensor-core dims, and K6's ``pingpong`` test and
    instances are its ping-pong dims: a launch the wrapper names "wgmma"
    (forced too) or "pingpong" is one the entry takes, and no other."""
    src = open(FK.__file__.replace("kernels/flash_attention/kernel.py",
                                   f"csrc/{source}")).read()
    test = re.search(r"const bool tensor_cores =(.*?);", src, re.S).group(1)
    pairs = {(int(d), int(dv))
             for d, dv in re.findall(r"D == (\d+) && Dv == (\d+)", test)}
    assert pairs == set(FK.WGMMA_HEAD_DIMS)
    assert re.match(r"\s*dtype == 1 && \(", test)          # bf16 only
    assert FK.DTYPES[torch.bfloat16] == 1
    launched = {(int(d), int(dv)) for d, dv in
                re.findall(r"return launch_wgmma<(\d+), (\d+)>", src)}
    assert launched == pairs
    pingpong = set()
    if source == "flash_attention.cu":
        test = re.search(r"const bool pingpong =(.*?);", src, re.S).group(1)
        assert re.match(r"\s*dtype == 1 && \(", test)
        pingpong = {(int(d), int(dv)) for d, dv in
                    re.findall(r"D == (\d+) && Dv == (\d+)", test)}
        assert pingpong == set(FK.PINGPONG_HEAD_DIMS) <= pairs
        assert pingpong == {(int(d), int(dv)) for d, dv in re.findall(
            r"return launch_pingpong<(\d+), (\d+)>", src)}
        assert FK.VARIANTS == {"simt": 0, "wgmma": 1, "pingpong": 2}
        assert re.search(r"if \(variant == 2\) \{\s*if \(!pingpong", src)
        # the ping-pong kernel regroups 24 / 240 / 240 and its launch
        # refuses a build that does not start at the 168 registers that
        # regrouping needs (check_regs, shared with K7 in hopper.cuh)
        kernel = src[src.index("flash_attention_pingpong_kernel("):
                     src.index("int launch_pingpong(")]
        assert "setmaxnreg.dec.sync.aligned.u32 24;" in kernel
        assert "setmaxnreg.inc.sync.aligned.u32 240;" in kernel
        launch = src[src.index("int launch_pingpong("):]
        assert re.search(r"check_regs\(kernel, &regs\);\s*if \(e == "
                         r"cudaSuccess\)", launch)
        hopper = open(FK.__file__.replace(
            "kernels/flash_attention/kernel.py", "csrc/hopper.cuh")).read()
        assert "constexpr int kLaunchRegs = 168;" in hopper
        assert ("*cached == kLaunchRegs ? cudaSuccess : "
                "cudaErrorInvalidKernelImage") in hopper
    for D in range(1, FK.MAX_HEAD_DIM + 1):
        for Dv in (D, 64, 128):
            want = ("pingpong" if (D, Dv) in pingpong else
                    "wgmma" if (D, Dv) in pairs else "simt")
            got = FK.variant(torch.bfloat16, D, Dv)
            assert got == want or (not pingpong and got == "pingpong"
                                   and (D, Dv) in pairs)
            assert FK.variant(torch.float32, D, Dv) == "simt"


@pytest.mark.parametrize("dtype,D,Dv,msg", [
    (torch.bfloat16, 257, 257, "head dims"),
    (torch.bfloat16, 320, 320, "head dims"),
    (torch.bfloat16, 64, 257, "head dims"),
    (torch.float32, 320, 64, "head dims"),
    (torch.bfloat16, 0, 64, "head dims"),
    (torch.float16, 64, 64, "float32 or bfloat16"),
])
def test_variant_refuses_before_any_launch(dtype, D, Dv, msg):
    """A head dim past 256 (or a dtype K6 lacks) is refused by variant()
    and by the wrapper, before anything is built or launched."""
    with pytest.raises(ValueError, match=msg):
        FK.variant(dtype, D, Dv)
    counts = dict(FK.KERNEL.launches_by_variant)
    q = torch.zeros(2, 4, D, dtype=dtype)
    v = torch.zeros(2, 4, Dv, dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        FK.flash_attention_cuda(q, q, v)
    assert FK.KERNEL._fn is None
    assert FK.KERNEL.launches_by_variant == counts


@pytest.mark.parametrize("D,force,msg", [(16, "wgmma", "wgmma kernel takes"),
                                         (16, "pingpong",
                                          "pingpong kernel takes"),
                                         (64, "tensor", "unknown variant")])
def test_forced_variant_is_checked_before_any_launch(D, force, msg):
    """The SIMT kernel may be forced onto any inputs; the tensor-core
    kernels only onto inputs that qualify (the C entry holds the same
    rule)."""
    q = torch.zeros(4, 8, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=msg):
        FK.flash_attention_cuda(q, q, q, force_variant=force)
    assert FK.KERNEL._fn is None


def test_k6_names_both_kernels_and_counts_each():
    """device_fns names every __global__ function of the source (the
    three kernels), and launches_by_variant has a count for each variant;
    reset_counts zeroes all of them."""
    src = open(FK.__file__.replace("kernels/flash_attention/kernel.py",
                                   "csrc/flash_attention.cu")).read()
    for fn in FK.KERNEL.device_fns:
        assert f"\n{fn}(" in src
    assert len(FK.KERNEL.device_fns) == src.count("__global__ void")
    assert set(FK.KERNEL.launches_by_variant) == {"simt", "wgmma",
                                                  "pingpong"}
    saved = (FK.KERNEL.launches, dict(FK.KERNEL.launches_by_variant))
    FK.KERNEL.launches_by_variant["wgmma"] = 3
    FK.KERNEL.launches_by_variant["pingpong"] = 2
    FK.KERNEL.launches = 5
    FK.KERNEL.reset_counts()
    assert FK.KERNEL.launches == 0
    assert FK.KERNEL.launches_by_variant == {"simt": 0, "wgmma": 0,
                                             "pingpong": 0}
    FK.KERNEL.launches, FK.KERNEL.launches_by_variant = saved


# -- the ping-pong kernel's work plan and its split-and-merge ----------------

SMS = 132     # an H100's SMs: the plan the card runs at the models' shapes


def _kept_tiles(q0, Sq, Sk, causal, tile):
    """Key tiles of the item at q0 holding a (row < Sq, key < Sk) pair the
    mask keeps: by brute force over the pairs, independent of the plan."""
    rows = np.arange(q0, min(q0 + tile, Sq))
    kept = set()
    for kt in range(-(-Sk // tile)):
        keys = np.arange(kt * tile, min((kt + 1) * tile, Sk))
        if not causal or (keys[:, None] <= rows[None, :]).any():
            kept.add(kt)
    return kept


@pytest.mark.parametrize("BH,Sq,Sk,causal,sms,tile", [
    (24, 1500, 1500, False, SMS, 128),  # whisper's encoder: items cut
    (32, 3904, 3904, True, SMS, 128),   # llava's rows at 32 heads: cut
    (128, 1024, 1024, True, SMS, 128),  # granite's: whole items
    (8, 1000, 1000, True, SMS, 128),    # up to 3 parts an item
    (24, 330, 200, True, SMS, 128),     # Sq > Sk
    (6, 200, 330, False, 7, 128),
    (4, 45, 45, True, 5, 16),           # the numeric model's plans
    (3, 150, 150, False, 4, 16)])
def test_plan_covers_every_kept_tile_once(BH, Sq, Sk, causal, sms, tile):
    """Every (head, query tile, key tile) the mask keeps is covered by
    exactly one part, no masked tile by any; a cut item's parts are its
    key tiles in order, numbered 0.. in that order, and own consecutive
    partials and one counter of their own; no block is empty, and whole
    items take min(items, sms) blocks; the plan of a shape is the same
    every time it is made."""
    p = FK.plan.__wrapped__(BH, Sq, Sk, causal, sms, tile)
    assert p == FK.plan.__wrapped__(BH, Sq, Sk, causal, sms, tile)
    its = FK.items(BH, Sq, Sk, causal, tile)
    assert 0 < len(p.blocks) <= sms and all(p.blocks)
    if not p.n_counters:
        assert len(p.blocks) == min(len(its), sms)
    by_item = {}
    for parts in p.blocks:
        for bh, q0, k0, k1, part, nparts, first, counter in parts:
            assert 0 <= k0 < k1
            by_item.setdefault((bh, q0), []).append(
                (part, nparts, k0, k1, first, counter))
    assert set(by_item) == {(bh, qt * tile) for bh in range(BH)
                            for qt in range(-(-Sq // tile))}
    firsts, counters = [], []
    for (bh, q0), parts in by_item.items():
        parts.sort()
        n = len(parts)
        assert [x[0] for x in parts] == list(range(n))
        assert {x[1] for x in parts} == {n}
        tiles = [kt for _, _, k0, k1, _, _ in parts for kt in range(k0, k1)]
        assert tiles == sorted(_kept_tiles(q0, Sq, Sk, causal, tile))
        assert len({(x[4], x[5]) for x in parts}) == 1
        if n == 1:
            assert parts[0][4:] == (-1, -1)
        else:
            firsts.append((parts[0][4], n))
            counters.append(parts[0][5])
    assert sorted(counters) == list(range(p.n_counters))
    spans = sorted(firsts)
    assert [f for f, _ in spans] == [sum(n for _, n in spans[:i])
                                     for i in range(len(spans))]
    assert sum(n for _, n in spans) == p.n_partials
    # the kernel's array: parts block after block, then G + 1 offsets
    arr = FK.plan_array(p)
    n_parts = sum(len(b) for b in p.blocks)
    assert len(arr) == FK.PART_FIELDS * n_parts + len(p.blocks) + 1
    assert arr[FK.PART_FIELDS * n_parts:] == list(
        np.cumsum([0] + [len(b) for b in p.blocks]))


def _round_robin_steps(BH, Sq, Sk, causal, sms):
    """Key-tile steps of the longest block under the wgmma kernel's
    schedule: whole items, heaviest first, block b taking items b, b + G,
    ..."""
    its = FK.items(BH, Sq, Sk, causal)
    G = min(len(its), sms)
    return max(sum(n for _, _, n in its[b::G]) for b in range(G))


@pytest.mark.parametrize("name,BH,S,causal", [
    ("whisper", 24, 1500, False), ("llava", 128, 3904, True),
    ("granite", 128, 1024, True), ("qwen", 160, 1024, True),
    ("whisper training", 48, 1500, False)])
def test_plan_balances_the_models_shapes(name, BH, S, causal):
    """Arithmetic only, on 132 SMs: at whisper's encoder shape the longest
    block walks at most 1.1x the mean key-tile steps (the one-schedule
    order gives 36 against 26.2); at every shape no more than that order's
    longest block, and within 1.1x of the mean; the causal shapes' blocks
    take whole items, their counts differing by at most one."""
    p = FK.plan(BH, S, S, causal, SMS)
    steps = FK.block_steps(p)
    mean = sum(steps) / len(steps)
    rr = _round_robin_steps(BH, S, S, causal, SMS)
    assert max(steps) <= rr and max(steps) <= 1.1 * mean
    if name == "whisper":
        assert rr == 36
    if causal:
        counts = [len(b) for b in p.blocks]
        assert p.n_counters == 0 and max(counts) - min(counts) <= 1


def _bf16(x):
    """Round f32 to bf16 (nearest even) and back, in numpy."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def split_merge_model(q, k, v, group, causal, p, tile, bf16):
    """The ping-pong kernel's arithmetic on plan ``p``, in numpy f32: per
    part the online softmax over its key tiles (S from the inputs in f32,
    the raw-score max m, p = 2^(s sl - m sl) with sl = scale log2 e, l
    summing the unrounded p, p rounded to bf16 only as P V's operand when
    ``bf16``); a whole item's o / max(l, 1e-30); a cut item's parts merged
    in part order, each rescaled once by 2^((m_i - m) sl). Returns (o,
    lse) in f32, o rounded to bf16 once when ``bf16``."""
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[2]
    sl = np.float32(D ** -0.5) * np.float32(np.log2(np.e))
    out = np.zeros((BH, Sq, Dv), np.float32)
    lse = np.zeros((BH, Sq), np.float32)
    cut = {}

    def pad(x, r0):
        t = np.zeros((tile, x.shape[-1]), np.float32)
        part = x[r0:r0 + tile]
        t[:len(part)] = part
        return t

    def finish(bh, q0, o, m, l):
        den = np.maximum(l, np.float32(1e-30))
        n = min(tile, Sq - q0)
        o = (o / den[:, None])[:n]
        out[bh, q0:q0 + n] = _bf16(o) if bf16 else o
        lse[bh, q0:q0 + n] = (m * sl * np.float32(np.log(2))
                              + np.log(den))[:n]

    rows = np.arange(tile)
    for parts in p.blocks:
        for bh, q0, k0, k1, part, nparts, _, _ in parts:
            Q = pad(q[bh], q0)
            o = np.zeros((tile, Dv), np.float32)
            m = np.full(tile, -1e30, np.float32)
            l = np.zeros(tile, np.float32)
            for kt in range(k0, k1):
                K_, V_ = pad(k[bh // group], kt * tile), pad(v[bh // group],
                                                             kt * tile)
                s = Q @ K_.T
                keys = kt * tile + rows
                masked = (keys[None, :] >= Sk) | (
                    causal & (keys[None, :] > (q0 + rows)[:, None]))
                s = np.where(masked, np.float32(-1e30), s)
                mx = np.maximum(m, s.max(1))
                c = np.exp2((m - mx) * sl)
                pe = np.exp2(s * sl - (mx * sl)[:, None])
                l = l * c + pe.sum(1)
                o = o * c[:, None] + (_bf16(pe) if bf16 else pe) @ V_
                m = mx
            if nparts == 1:
                finish(bh, q0, o, m, l)
            else:
                cut.setdefault((bh, q0), {})[part] = (o, m, l)
    for (bh, q0), parts in cut.items():
        mm = np.max([parts[i][1] for i in range(len(parts))], axis=0)
        o = np.zeros_like(parts[0][0])
        l = np.zeros_like(parts[0][2])
        for i in range(len(parts)):          # part order, not arrival
            e = np.exp2((parts[i][1] - mm) * sl)
            l = l + parts[i][2] * e
            o = o + parts[i][0] * e[:, None]
        finish(bh, q0, o, mm, l)
    return out, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,group,causal,sms,tile,max_parts", [
    (1, 45, 1, True, 7, 8, 2),          # ragged, causal
    (4, 45, 4, False, 15, 8, 3),        # ragged, full softmax
    (4, 45, 4, True, 2, 8, 1),          # whole items
    (1, 150, 1, False, 3, 16, 2),
    (1, 150, 1, True, 11, 16, 3),
    (4, 150, 4, True, 41, 16, 3),
    (4, 150, 4, False, 9, 16, 3)])
def test_split_merge_model_matches_jax(rng, dtype, BH, S, group, causal,
                                       sms, tile, max_parts):
    """The split-and-merge, on plans the planner makes at 8- and 16-row
    tiles (1 to 3 parts an item), against the JAX package's reference
    ``flash_attention_ref`` within ATT_TOL, and its lse within 1e-4 of
    the logsumexp of JAX's masked scores."""
    import jax
    D = 16
    qj, qt = _both(rng.standard_normal((BH, S, D)), dtype)
    kj, kt = _both(rng.standard_normal((BH // group, S, D)), dtype)
    vj, vt = _both(rng.standard_normal((BH // group, S, D)), dtype)
    p = FK.plan.__wrapped__(BH, S, S, causal, sms, tile)
    assert max(x[5] for b in p.blocks for x in b) == max_parts
    got, lse = split_merge_model(_np(qt), _np(kt), _np(vt), group, causal,
                                 p, tile, dtype == "bfloat16")
    want = flash_attention_ref(qj, kj, vj, group=group, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)
    s = jnp.einsum("bqd,bkd->bqk", qj.astype(jnp.float32),
                   kj.astype(jnp.float32)[jnp.arange(BH) // group]) \
        * D ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None], s, -1e30)
    np.testing.assert_allclose(lse, _np(jax.nn.logsumexp(s, -1)), rtol=0,
                               atol=1e-4)
