"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU, at zamba2-2.7b's REDUCED
widths (d 64, SSM head 16, state 16, chunk 32) in f32.

Inputs and parameters are drawn with numpy and handed to both packages;
the reference's functions run jitted (eagerly they cost seconds a call).
Tolerance: every output and state within 2e-5 of its largest element (the
same f32 arithmetic summed in another order: the port takes all chunks
at once where the reference maps over them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as S
from repro_torch.models.param import tree_map_descs

TOL = 2e-5
ARCH = "zamba2-2.7b"


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def _both(a):
    """(a numpy f32 array) -> (JAX array, torch tensor)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _cfgs():
    f32 = dict(dtype="float32", param_dtype="float32")
    return (jax_config(ARCH, reduced=True).replace(**f32),
            get_config(ARCH, reduced=True).replace(**f32))


def _params(seed):
    """One Mamba2 block's parameters at REDUCED width, random (A_log, D,
    dt_bias and the norm scale too), as (JAX tree, torch tree)."""
    rng = np.random.default_rng(seed)
    _, cfg = _cfgs()

    def draw(path, d):
        a = rng.standard_normal(d.shape).astype(np.float32)
        if path[0].startswith("in_") or path[0] == "out":
            return a * d.shape[0] ** -0.5
        if path[0] == "dt_bias":
            return a * 0.5 - 1.0
        if path[0] == "norm":
            return 1.0 + 0.1 * a
        return a * 0.5
    tree = tree_map_descs(draw, S.mamba2_descs(cfg))

    def split(node, i):
        if isinstance(node, dict):
            return {k: split(v, i) for k, v in node.items()}
        return _both(node)[i]
    return split(tree, 0), split(tree, 1)


def test_causal_conv_and_conv_step_match_jax(rng):
    """The depthwise causal conv over a sequence, and the one-step conv
    from a carried window, against the reference; the step's window is
    the last W - 1 inputs."""
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    _close(S._causal_conv(tx, tw, tb), JS._causal_conv(jx, jw, jb))
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    (js, ts), (jt, tt) = _both(state), _both(x[:, 0])
    y, st = S._conv_step(tt, ts, tw, tb)
    jy, jst = JS._conv_step(jt, js, jw, jb)
    _close(y, jy)
    _close(st, jst)
    # the step over the conv's last window gives the conv's last output
    y, _ = S._conv_step(tx[:, -1], tx[:, -4:-1], tw, tb)
    _close(y, S._causal_conv(tx, tw, tb)[:, -1].numpy())


@pytest.mark.parametrize("S_,chunk,G,with_state", [
    (64, 32, 1, False),      # two whole chunks
    (40, 32, 2, True),       # 40 % 32 != 0: the chunk shrinks to 20; an
])                           # entering state; two groups of B / C
def test_ssd_chunked_matches_jax(rng, S_, chunk, G, with_state):
    """y and the final (b, H, P, N) state against the reference's scan."""
    b, H, P, N = 2, 8, 16, 16
    x = rng.standard_normal((b, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S_, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, S_, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S_, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = (rng.standard_normal((b, H, P, N)).astype(np.float32)
          if with_state else None)
    j = [_both(a) for a in (x, dt, A, B, C, D)]
    jy, jS = jax.jit(JS.ssd_chunked, static_argnums=6)(
        *(a for a, _ in j), chunk, None if s0 is None else jnp.asarray(s0))
    ty, tS = S.ssd_chunked(*(t for _, t in j), chunk,
                           None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == tS.dtype == torch.float32
    _close(ty, jy)
    _close(tS, jS)


def test_mamba2_train_matches_jax(rng):
    """The block's forward over 40 positions (chunk 20) against
    ``mamba2_train``; ``return_state`` changes nothing of the output and
    gives the decode state's leaves in f32 (their values are held against
    the reference's prefill cache in tests/test_torch_hybrid.py), the conv
    windows being the last 3 pre-conv linear outputs."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jx, tx = _both(x)
    want = jax.jit(JS.mamba2_train, static_argnums=2)(jp, jx, jcfg)
    y = S.mamba2_train(tp, tx, cfg)
    _close(y, want)
    y2, st = S.mamba2_train(tp, tx, cfg, return_state=True)
    assert torch.equal(y, y2)
    descs = S.mamba2_state_descs(cfg, 2)
    assert {n: (tuple(t.shape), t.dtype) for n, t in st.items()} == {
        n: (d.shape, torch.float32) for n, d in descs.items()}
    for name, leaf in ("conv_x", "in_x"), ("conv_b", "in_b"), \
            ("conv_c", "in_c"):
        _close(st[name], np.asarray(jx @ jp[leaf]["w"])[:, -3:])


def test_mamba2_decode_matches_jax(rng):
    """Three recurrent steps from a random state against
    ``mamba2_decode``: each step's output and every state leaf."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(4)
    descs = S.mamba2_state_descs(cfg, 2)
    st = {n: rng.standard_normal(d.shape).astype(np.float32)
          for n, d in descs.items()}
    js = {n: jnp.asarray(a) for n, a in st.items()}
    ts = {n: torch.from_numpy(a.copy()) for n, a in st.items()}
    step = jax.jit(JS.mamba2_decode, static_argnums=2)
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, js = step(jp, jnp.asarray(x), jcfg, js)
        ty, ts = S.mamba2_decode(tp, torch.from_numpy(x), cfg, ts)
        _close(ty, jy)
        for n in descs:
            assert ts[n].dtype == torch.float32
            _close(ts[n], js[n])
