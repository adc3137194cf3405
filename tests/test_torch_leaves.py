"""The PyTorch port's bit-level leaves against the JAX reference.

Wire schema (pack / unpack / repack, ``set_report_reporter``), the
rotate-xor checksum and ``payload_valid``, and the log*/exp*/approx_pow
LUT pipeline, under both wire formats, on random u32 words plus the
corners 0, 1, 2^31 and 0xFFFFFFFF. Integers must match bit for bit.

Also holds the small conversion helpers the other ``test_torch_*``
files import.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import logstar as JLS
from repro.core import protocol as JPROTO
from repro.core import wire as JWIRE
from repro_torch import u32 as U
from repro_torch.core import logstar as LS
from repro_torch.core import protocol as PROTO
from repro_torch.core import wire as WIRE

CORNERS = np.array([0, 1, 2, 3, 127, 128, 255, 256, 65535, 65536,
                    1 << 31, (1 << 31) + 1, 0xFFFFFFFE, 0xFFFFFFFF],
                   np.uint32)
FORMATS = [(JWIRE.V1, WIRE.V1), (JWIRE.V2, WIRE.V2)]


def T(a, dtype=None):
    """numpy/JAX array -> port tensor (u32 as int32 bit patterns, bool
    as bool)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy())
    if dtype is not None:
        return torch.from_numpy(a.astype(dtype))
    return U.from_numpy(a)


def N(t):
    """port tensor -> numpy (u32 for int32 / int64 words, bool as is)."""
    if t.dtype == torch.bool:
        return t.numpy()
    if t.dtype.is_floating_point:
        return t.numpy()
    return U.to_numpy(t)


def assert_same(want, got, msg=""):
    want = np.asarray(want)
    got = N(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got.astype(bool), want, err_msg=msg)
    else:
        np.testing.assert_array_equal(got.astype(np.uint64) & 0xFFFFFFFF,
                                      want.astype(np.uint64) & 0xFFFFFFFF,
                                      err_msg=msg)


def rand_u32(rng, shape):
    words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return words.astype(np.uint32)


def with_corners(rng, n):
    return np.concatenate([CORNERS, rand_u32(rng, n)])


# -- wire + protocol ----------------------------------------------------------

@pytest.mark.parametrize("jwf,twf", FORMATS, ids=["v1", "v2"])
def test_report_and_payload_roundtrip(rng, jwf, twf):
    R = 64
    flow, rid, seq = (rand_u32(rng, R) for _ in range(3))
    stats, tup = rand_u32(rng, (R, 7)), rand_u32(rng, (R, 5))
    hist = rng.integers(0, 10, R).astype(np.uint32)
    jr = JPROTO.pack_dta_report(*(jnp.asarray(a) for a in
                                  (flow, rid, seq, stats, tup)), wire=jwf)
    tr = PROTO.pack_dta_report(*(T(a) for a in (flow, rid, seq, stats, tup)),
                               wire=twf)
    assert tr.dtype == torch.int32
    assert_same(jr, tr)
    jrep = JPROTO.unpack_dta_report(jr, wire=jwf)
    trep = PROTO.unpack_dta_report(tr, wire=twf)
    for k in jrep:
        assert_same(jrep[k], trep[k], k)
    jp = JPROTO.pack_rocev2_payload(jrep, jnp.asarray(hist), wire=jwf)
    tp = PROTO.pack_rocev2_payload(trep, T(hist), wire=twf)
    assert_same(jp, tp)
    jun, tun = (JPROTO.unpack_payload(jp, wire=jwf),
                PROTO.unpack_payload(tp, wire=twf))
    for k in jun:
        assert_same(jun[k], tun[k], k)
    # repack: overwrite the reporter field of the report meta word
    new_rid = rand_u32(rng, R)
    mw = jwf.report_meta_word
    assert_same(jwf.set_report_reporter(jr[:, mw], jnp.asarray(new_rid)),
                twf.set_report_reporter(tr[:, mw], T(new_rid)))


@pytest.mark.parametrize("jwf,twf", FORMATS, ids=["v1", "v2"])
def test_checksum_and_payload_valid(rng, jwf, twf):
    R = 96
    rep = {"flow_id": rand_u32(rng, R), "reporter_id": rand_u32(rng, R),
           "seq": rand_u32(rng, R), "stats": rand_u32(rng, (R, 7)),
           "five_tuple": rand_u32(rng, (R, 5))}
    hist = rng.integers(0, 10, R).astype(np.uint32)
    jp = np.asarray(JPROTO.pack_rocev2_payload(
        {k: jnp.asarray(v) for k, v in rep.items()}, jnp.asarray(hist),
        wire=jwf)).copy()
    # flip one random bit in half of the rows (any word, checksum too)
    rows = rng.random(R) < 0.5
    words = rng.integers(0, 16, R)
    bits = rng.integers(0, 32, R).astype(np.uint32)
    jp[rows, words[rows]] ^= (np.uint32(1) << bits[rows])
    want = np.asarray(JPROTO.payload_valid(jnp.asarray(jp), wire=jwf))
    assert not want[rows].any() and want[~rows].all()
    assert_same(want, PROTO.payload_valid(T(jp), wire=twf))
    words16 = rand_u32(rng, (R, 16))
    assert_same(JPROTO.xor_checksum(jnp.asarray(words16)),
                PROTO.xor_checksum(T(words16)))


def test_wire_geometry_and_resolution(monkeypatch):
    for jwf, twf in FORMATS:
        for f in ("n_reporters", "seq_mask", "seq_dup_window",
                  "hist_counter_mask", "report_meta_word",
                  "payload_meta_word", "csum_covered"):
            assert getattr(jwf, f) == getattr(twf, f), (jwf.name, f)
    monkeypatch.delenv(WIRE.ENV_VAR, raising=False)
    assert WIRE.resolve() is WIRE.V1
    monkeypatch.setenv(WIRE.ENV_VAR, "v2")
    assert WIRE.resolve() is WIRE.V2
    monkeypatch.setenv(WIRE.ENV_VAR, "v9")
    with pytest.raises(ValueError, match="unknown value 'v9' from env var "
                                         "REPRO_WIRE_FORMAT"):
        WIRE.resolve()


# -- u32 representation + log* ------------------------------------------------

def test_u32_bit_patterns_roundtrip(rng):
    a = with_corners(rng, 200)
    t = U.from_numpy(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(U.to_numpy(t), a)
    w = U.wide(t)
    assert int(w.min()) >= 0 and int(w.max()) <= 0xFFFFFFFF
    np.testing.assert_array_equal(U.to_numpy(U.narrow(w + (1 << 32))), a)


def test_bit_length_matches_clz_corners():
    x = torch.tensor([0, 1, 2, 3, 1 << 31, 0xFFFFFFFF], dtype=torch.int64)
    assert LS.bit_length(x).tolist() == [0, 1, 2, 2, 32, 32]


@pytest.mark.parametrize("bits", [7, 4])
def test_logstar_pipeline_bitwise(rng, bits):
    x = with_corners(rng, 3000)
    log_lut, exp_lut = JLS._luts(bits)
    tlog, texp = LS.lut_tensors(bits)
    np.testing.assert_array_equal(LS._luts(bits)[0], log_lut)
    np.testing.assert_array_equal(LS._luts(bits)[1], exp_lut)
    assert_same(JLS.log2_star_with_lut(jnp.asarray(x), bits,
                                       jnp.asarray(log_lut)),
                LS.log2_star_with_lut(T(x), bits, tlog))
    # exp* over log-domain values, including saturating exponents
    l = np.concatenate([CORNERS, rand_u32(rng, 1000),
                        rng.integers(0, 40 << 16, 2000).astype(np.uint32)])
    assert_same(JLS.exp2_star_with_lut(jnp.asarray(l), bits,
                                       jnp.asarray(exp_lut)),
                LS.exp2_star_with_lut(T(l), bits, texp))
    for n in (2, 3):
        assert_same(JLS.approx_pow(jnp.asarray(x), n, bits),
                    LS.approx_pow(T(x), n, bits), f"pow {n}")
