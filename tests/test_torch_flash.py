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


def test_chunked_attention_refuses_a_query_offset(rng):
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(NotImplementedError, match="top-left"):
        TA.chunked_attention(q, q, q, q_offset=3)


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


# kernel.variant: which of K6's two kernels a launch runs
VARIANT_CASES = [
    # dtype, D, Dv, variant
    (torch.bfloat16, 64, 64, "wgmma"),       # granite-3-2b's head dim
    (torch.bfloat16, 128, 128, "wgmma"),     # the larger families'
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
    """K6 forced onto "wgmma" outside the rule raises before anything is
    built or launched; zamba2's bf16 (80, 80) passes the rule and stops
    only at the CPU tensors."""
    q, k = torch.zeros(4, 8, D, dtype=dtype), torch.zeros(2, 8, D,
                                                           dtype=dtype)
    v = torch.zeros(2, 8, Dv, dtype=dtype)
    with pytest.raises(ValueError, match="wgmma kernel takes bf16"):
        FK.flash_attention_cuda(q, k, v, group=2, force_variant="wgmma")
    q, k = torch.zeros(4, 8, 80, dtype=torch.bfloat16), torch.zeros(
        2, 8, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention_cuda(q, k, k, group=2, force_variant="wgmma")
    assert FK.KERNEL._fn is None and FK.KERNEL.launches == 0


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "flash_attention_bwd.cu"])
def test_c_entries_hold_the_variant_rule(source):
    """The (D, Dv) pairs of each C entry's ``tensor_cores`` test, its
    bf16-only condition and the wgmma instances it dispatches to are
    ``variant()``'s: a launch the wrapper names "wgmma" is one the entry
    takes, and no other."""
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
    for D in range(1, FK.MAX_HEAD_DIM + 1):
        for Dv in (D, 64, 128):
            want = "wgmma" if (D, Dv) in pairs else "simt"
            assert FK.variant(torch.bfloat16, D, Dv) == want
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
                                         (64, "tensor", "unknown variant")])
def test_forced_variant_is_checked_before_any_launch(D, force, msg):
    """The SIMT kernel may be forced onto any inputs; the wgmma kernel only
    onto inputs that qualify (the C entry holds the same rule)."""
    q = torch.zeros(4, 8, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=msg):
        FK.flash_attention_cuda(q, q, q, force_variant=force)
    assert FK.KERNEL._fn is None


def test_k6_names_both_kernels_and_counts_each():
    """device_fns names both __global__ functions of the source, and
    launches_by_variant has a count for each variant; reset_counts zeroes
    all of them."""
    src = open(FK.__file__.replace("kernels/flash_attention/kernel.py",
                                   "csrc/flash_attention.cu")).read()
    for fn in FK.KERNEL.device_fns:
        assert f"\n{fn}(" in src
    assert set(FK.KERNEL.launches_by_variant) == {"simt", "wgmma"}
    saved = (FK.KERNEL.launches, dict(FK.KERNEL.launches_by_variant))
    FK.KERNEL.launches_by_variant["wgmma"] = 3
    FK.KERNEL.launches = 3
    FK.KERNEL.reset_counts()
    assert FK.KERNEL.launches == 0
    assert FK.KERNEL.launches_by_variant == {"simt": 0, "wgmma": 0}
    FK.KERNEL.launches, FK.KERNEL.launches_by_variant = saved
