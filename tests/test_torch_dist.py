"""The port's training and launch modules that act across devices, against
the JAX package on the CPU: int8 error-feedback gradient compression
(``optim.compression``), the pod-axis GPipe schedule
(``distributed.pipeline``), the meshes (``launch.mesh``) and the
assigned shapes (``configs.shapes``).

The reference runs ``compressed_psum`` and ``pipeline_apply`` inside
``shard_map`` on a ("pod", "data") = (2, 2) mesh of the forced host
devices; the port emulates the same ranks on one device, stacked on a
leading dim (compression) or one after another (the pipeline). Inputs are
numpy draws from a seed. Tolerances: compression bit for bit; the
pipeline within 1e-5 of the output's largest element in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config as jax_config
from repro.configs import shapes as JSH
from repro.distributed.pipeline import pipeline_apply as jax_pipeline_apply
from repro.launch import mesh as JMESH
from repro.models import lm as JLM
from repro.optim import compression as JC
from repro_torch import configs as CFG
from repro_torch.configs import get_config
from repro_torch.configs import shapes as SH
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch import mesh as MESH
from repro_torch.models import lm as LM
from repro_torch.optim import adamw
from repro_torch.optim import compression as C
from torch_cross import numpy_params, to_np

AXES = ("pod", "data")
RANKS = 4


@pytest.fixture(scope="module")
def pod_data():
    """(the reference's ("pod", "data") = (2, 2) mesh on the first 4
    forced host devices, the port's emulated one on the CPU)."""
    if jax.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} forced host devices, have "
                    f"{jax.device_count()}")
    jmesh = compat.make_mesh((2, 2), AXES, devices=jax.devices()[:RANKS])
    return jmesh, MESH.EmulatedMesh(AXES, (2, 2), torch.device("cpu"))


def _bits(got, want):
    """Bit for bit: the same dtype, shape and bytes."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


# -------------------------------------------------------------- compression

def _quantize_inputs():
    """name -> (g, err) f32 numpy: random with a residual carried in; ties
    at .5 (max |x| 127, so the scale is 1 and x / scale = x); an all-zero
    leaf (the 1e-12 scale floor)."""
    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.0],
                    np.float32)
    return {
        "random": ((rng.standard_normal((6, 33)) * 0.01).astype(np.float32),
                   (rng.standard_normal((6, 33)) * 1e-4).astype(np.float32)),
        "ties": (ties, np.zeros_like(ties)),
        "zeros": (np.zeros((4, 5), np.float32), np.zeros((4, 5), np.float32)),
    }


@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_quantize_and_dequantize_match_jax_bitwise(case):
    """q, scale, the residual and the dequantized values equal the
    reference's jitted functions' bit for bit, round half to even
    included. (Compiled, XLA rounds x - q * scale once; op by op the
    reference rounds the product first and differs in the residual's last
    bits.)"""
    g, e = _quantize_inputs()[case]
    jq, js, jr = jax.jit(JC.quantize)(jnp.asarray(g), jnp.asarray(e))
    q, s, r = C.quantize(torch.from_numpy(g), torch.from_numpy(e))
    for got, want in ((q, jq), (s, js), (r, jr),
                      (C.dequantize(q, s), jax.jit(JC.dequantize)(jq, js))):
        _bits(got, want)
    if case == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, 3]
    if case == "zeros":
        assert float(s) == np.float32(1e-12) / np.float32(127.0)
    init = C.init_error({"a": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert init["a"].dtype == torch.float32 and not init["a"].any()


def _rank_trees(seed):
    """Each rank's gradients and residuals, numpy: {"w": (4, 2, 64) f32,
    "b": (4, 3) bf16-valued f32} and f32 residuals, stacked by rank."""
    rng = np.random.default_rng(seed)
    g = {"w": (rng.standard_normal((RANKS, 2, 64)) * 0.01).astype(np.float32),
         "b": rng.standard_normal((RANKS, 3)).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
         for k, v in g.items()}
    return g, e


def test_compressed_psum_matches_jax_bitwise(pod_data):
    """Two rounds over 4 ranks of ("pod", "data"), the second carrying the
    first's residuals: the mean gradients and every rank's residuals equal
    the reference's inside shard_map bit for bit; the mean of a round lies
    within scale / 2 of the exact mean of g + err, plus the f32 rounding
    of x / scale (127 x 2^-23 x scale) and of the mean (2 x 2^-23 of its
    largest element)."""
    jmesh, tmesh = pod_data
    spec = P(AXES)

    def local(g, e):
        return JC.compressed_psum(g, e, AXES)

    fn = jax.jit(compat.shard_map(local, mesh=jmesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec)))
    g, e = _rank_trees(5)
    je = {k: jnp.asarray(v.reshape(-1, *v.shape[2:])) for k, v in e.items()}
    te = {k: torch.from_numpy(v) for k, v in e.items()}
    for rnd in range(2):
        jg = {k: jnp.asarray(v.reshape(-1, *v.shape[2:]))
              for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jmean, je = fn(jg, je)
        mean, new_te = C.compressed_psum(tg, te, tmesh, AXES)
        for k in g:
            _bits(mean[k].reshape(-1, *mean[k].shape[2:]), jmean[k])
            _bits(new_te[k].reshape(-1, *new_te[k].shape[2:]), je[k])
            x = tg[k].double() + te[k].double()
            scale = float((tg[k] + te[k]).abs().max()) / 127
            exact = x.mean(0)
            err = float((mean[k].double() - exact).abs().max())
            eps = float(np.finfo(np.float32).eps)
            slack = eps * (127 * scale + 2 * float(exact.abs().max()))
            assert err <= scale / 2 + slack, (rnd, k, err, scale)
            assert all(torch.equal(m, mean[k][0]) for m in mean[k])
        te = new_te
        g, _ = _rank_trees(6 + rnd)


def test_compressed_psum_refuses_a_leaf_not_stacked_by_rank(pod_data):
    _, tmesh = pod_data
    with pytest.raises(ValueError, match="4 ranks"):
        C.compressed_psum({"w": torch.zeros(3, 2)}, {"w": torch.zeros(3, 2)},
                          tmesh, AXES)


# ----------------------------------------------------------------- pipeline

def _jax_pipeline(jmesh, stage_fn, params, x, num_micro=2):
    with jmesh:
        return jax.jit(lambda p, x: jax_pipeline_apply(
            stage_fn, p, x, jmesh, axis="pod", num_micro=num_micro))(params,
                                                                      x)


def test_pipeline_tanh_stages_match_jax(pod_data):
    """The reference test's stage, tanh(x @ w), 2 stages over the pod axis
    and 2 data shards, 2 microbatches each: equal to the reference's
    pipeline and to the stages applied in order."""
    jmesh, tmesh = pod_data
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 4, 16)).astype(np.float32)
    want = _jax_pipeline(jmesh, lambda p, x, s: jnp.tanh(x @ p["w"]),
                         {"w": jnp.asarray(w)}, jnp.asarray(x))
    got = pipeline_apply(lambda p, x, s: torch.tanh(x @ p["w"]),
                         {"w": torch.from_numpy(w)}, torch.from_numpy(x),
                         tmesh, num_micro=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ref = x
    for s in range(2):
        ref = np.tanh(ref @ w[s])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_pipeline_of_llava_blocks_matches_jax(pod_data):
    """REDUCED llava's blocks as stages, 2 per stage (4 blocks), f32: the
    port's pipeline against the reference's within 1e-5 of the largest
    element; each stage sees its index, and runs once per microbatch and
    data shard (2 x 2 x 2 calls, the inactive ticks skipped)."""
    jmesh, tmesh = pod_data
    cfg = get_config("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32", param_dtype="float32", num_layers=4)
    jcfg = jax_config("llava-next-mistral-7b", reduced=True).replace(
        dtype="float32", param_dtype="float32", num_layers=4)
    tree = numpy_params(JLM.lm_descs(jcfg))
    stack = tree["stack_0_dense"]
    staged = jax.tree.map(lambda a: a.reshape(2, 2, *a.shape[1:]), stack)
    x = np.random.default_rng(1).standard_normal((8, 12, 64)).astype(
        np.float32)

    def jax_stage(p, h, sid):
        for i in range(2):
            h = JLM.block_train(jax.tree.map(lambda a: a[i], p), h, jcfg,
                                "dense", None, ())
        return h

    want = _jax_pipeline(jmesh, jax_stage,
                         jax.tree.map(jnp.asarray, staged), jnp.asarray(x))
    tstack = lm_params_from_numpy(tree, cfg, device="cpu")["stack_0_dense"]
    tstaged = adamw.tree_map(lambda a: a.reshape(2, 2, *a.shape[1:]), tstack)
    calls = []

    def stage(p, h, sid):
        calls.append(sid)
        for lp in LM.unstack(p, 2):
            h = LM.block_train(lp, h, cfg)
        return h

    got = pipeline_apply(stage, tstaged, torch.from_numpy(x), tmesh,
                         num_micro=2)
    err = float(np.abs(to_np(got) - np.asarray(want)).max())
    assert err <= 1e-5 * float(np.abs(np.asarray(want)).max()), err
    assert sorted(calls) == [0] * 4 + [1] * 4
    ref = torch.from_numpy(x)
    for lp in LM.unstack(tstack, 4):
        ref = LM.block_train(lp, ref, cfg)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_pipeline_refusals_match_jax(pod_data):
    """An axis that is not in the mesh (both packages name the 'pod'
    axis); a batch that does not split into microbatches (the reference
    asserts while tracing, the port raises ValueError)."""
    jmesh, tmesh = pod_data
    with pytest.raises(ValueError, match="pod"):
        jax_pipeline_apply(lambda p, x, s: x, {}, None,
                           compat.make_mesh((1, 1), ("data", "model")),
                           axis="pod")
    with pytest.raises(ValueError, match="'pod'") as err:
        pipeline_apply(lambda p, x, s: x, {}, torch.zeros(4, 2, 3),
                       MESH.make_local_mesh(device="cpu"), axis="pod")
    assert "('data', 'model')" in str(err.value)
    x = np.zeros((6, 2, 4), np.float32)
    with pytest.raises(AssertionError):
        _jax_pipeline(jmesh, lambda p, x, s: x, {"w": jnp.zeros((2, 1))},
                      jnp.asarray(x), num_micro=4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, x, s: x, {"w": torch.zeros(2, 1)},
                       torch.from_numpy(x), tmesh, num_micro=4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, x, s: x, {"w": torch.zeros(2, 1)},
                       torch.zeros(4, 2, 4), tmesh, num_micro=4)


# ------------------------------------------------------------ meshes, shapes

@pytest.mark.parametrize("pods,spp,n", [(1, 0, 8), (2, 0, 8), (4, 0, 8),
                                        (2, 2, 8), (1, 2, 4), (4, 2, 8)])
def test_dfa_mesh_matches_jax(pods, spp, n):
    """Shape and axis names of ``make_dfa_mesh`` over a prefix of n
    devices, the reference's on the forced host devices."""
    ref = JMESH.make_dfa_mesh(pods, spp, devices=jax.devices()[:n])
    got = MESH.make_dfa_mesh(pods, spp, n_devices=n, device="cpu")
    assert got.axis_names == tuple(ref.axis_names) == ("pod", "shard")
    assert got.axis_sizes == tuple(ref.devices.shape)
    assert got.shape == dict(ref.shape)
    assert got.device == torch.device("cpu")


@pytest.mark.parametrize("pods,spp,n", [(3, 0, 8), (2, 8, 8), (5, 0, 4)])
def test_dfa_mesh_refusals_match_jax(pods, spp, n):
    with pytest.raises(ValueError) as want:
        JMESH.make_dfa_mesh(pods, spp, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        MESH.make_dfa_mesh(pods, spp, n_devices=n, device="cpu")
    assert str(got.value) == str(want.value)


def test_local_and_production_meshes():
    """``make_local_mesh`` over the 8 forced devices is the reference's;
    over 1, 2 and 6 emulated devices the model axis takes 1, 2 and 2;
    the production meshes keep the reference's shapes and names (it
    needs 256 or 512 devices to build them); without a card the default
    device raises."""
    ref = JMESH.make_local_mesh()
    got = MESH.make_local_mesh(jax.device_count(), device="cpu")
    assert (got.axis_names, got.axis_sizes) == (tuple(ref.axis_names),
                                                tuple(ref.devices.shape))
    assert [MESH.make_local_mesh(n, device="cpu").axis_sizes
            for n in (1, 2, 6)] == [(1, 1), (1, 2), (3, 2)]
    one = MESH.make_production_mesh(device="cpu")
    two = MESH.make_production_mesh(multi_pod=True, device="cpu")
    assert (one.shape, one.size) == ({"data": 16, "model": 16}, 256)
    assert (two.shape, two.size) == ({"pod": 2, "data": 16, "model": 16},
                                     512)
    assert two.axis_size(("pod", "data")) == 32 and two.axis_size("pod") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MESH.make_local_mesh()


def test_shapes_are_the_references():
    """``configs.shapes`` field for field, ``shape_applicable`` for every
    family and shape, and the exports of ``configs``."""
    assert list(SH.SHAPES) == list(JSH.SHAPES)
    for name, want in JSH.SHAPES.items():
        got = CFG.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.tokens == want.tokens
    assert SH.SUBQUADRATIC_FAMILIES == JSH.SUBQUADRATIC_FAMILIES
    for family in ("dense", "vlm", "moe", "hybrid", "ssm", "encdec"):
        for shape in JSH.SHAPES.values():
            assert CFG.shape_applicable(family, SH.SHAPES[shape.name]) == \
                JSH.shape_applicable(family, shape)
    assert {"SHAPES", "ShapeConfig", "shape_applicable", "get_shape",
            "VisionStubConfig"} <= set(CFG.__all__)


def test_residual_slices_change_no_bit(monkeypatch):
    """The residual's f64 pass runs in slices of ``CHUNK`` elements; any
    slice length gives the same bits."""
    g, e = (torch.from_numpy(a) for a in _quantize_inputs()["random"])
    want = C.quantize(g, e)
    monkeypatch.setattr(C, "CHUNK", 7)
    for got, ref in zip(C.quantize(g, e), want):
        assert torch.equal(got, ref)
