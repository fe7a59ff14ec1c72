"""The Mamba2 block of the port (``repro_torch/models/ssm.py``) against
the JAX package's ``src/repro/models/ssm.py``, on the CPU.

Inputs come from numpy seeds and go through both packages; the layer
weights are JAX's ``init_mamba2`` at the zamba2-7b smoke size (d_model
128, d_in 256, 8 heads of 32, state 16), with its constant leaves
perturbed, carried over by ``repro_torch.convert``.  JAX runs jitted,
one program per section.

Tolerances: ``ssd_chunked`` (y and the final state) within 1e-5 of max
against JAX at chunks 4, 8 and 32 and against the NumPy sequential
oracle of tests/test_ssm.py, as is the init-state continuation;
``_causal_conv`` within 1e-6 (the same f32 taps in the same order);
``mamba2_block`` and ``mamba2_decode`` (y and the conv windows, which
hold the input projection's output) within 1e-5 of max in f32 and 1
bf16 ulp of max in bf16, the SSM states within 1e-5 of their max; the
gradient of ``ssd_chunked`` against ``jax.grad`` finite and within 1e-4
of each input's largest gradient.  Where JAX's chunking asserts (L =
513 at chunk 256), the port raises ``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.models import ssm
from test_ssm import sequential_ssd

torch.set_num_threads(2)

ARCH = "zamba2-7b"
CHUNKS = (4, 8, 32)
Bb, L, H, P, N = 2, 32, 3, 4, 8


def _ssd_inputs(seed, length=L):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, length, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, length, H)))).astype(
        np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((Bb, length, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((Bb, length, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# --------------------------------------------------------------------------
# the chunked scan
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ssd():
    """JAX's ssd_chunked at each chunk, and the continuation (the first 8
    positions, then the rest from their state), in one jitted program."""
    inputs = _ssd_inputs(0)

    @jax.jit
    def run(x, dt, A, Bm, Cm):
        out = {f"c{c}": jssm.ssd_chunked(x, dt, A, Bm, Cm, c) for c in CHUNKS}
        y1, S1 = jssm.ssd_chunked(x[:, :8], dt[:, :8], A, Bm[:, :8],
                                  Cm[:, :8], 4)
        y2, S2 = jssm.ssd_chunked(x[:, 8:], dt[:, 8:], A, Bm[:, 8:],
                                  Cm[:, 8:], 4, init_state=S1)
        out["cont"] = (jnp.concatenate([y1, y2], 1), S2)
        return out
    return inputs, jax.tree.map(np.asarray, run(*map(jnp.asarray, inputs)))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_ssd_chunked_matches_jax_and_sequential_oracle(jax_ssd, chunk):
    inputs, want = jax_ssd
    y, S = ssm.ssd_chunked(*_t(*inputs), chunk)
    assert y.dtype == S.dtype == torch.float32
    _close(y, want[f"c{chunk}"][0], 1e-5, "y vs JAX")
    _close(S, want[f"c{chunk}"][1], 1e-5, "S vs JAX")
    y_ref, S_ref = sequential_ssd(*inputs)
    _close(y, y_ref, 1e-5, "y vs the sequential oracle")
    _close(S, S_ref, 1e-5, "S vs the sequential oracle")


def test_ssd_init_state_continuation(jax_ssd):
    """The first 8 positions, then the rest from their final state, ==
    JAX's same split == one pass."""
    inputs, want = jax_ssd
    x, dt, A, Bm, Cm = _t(*inputs)
    y1, S1 = ssm.ssd_chunked(x[:, :8], dt[:, :8], A, Bm[:, :8], Cm[:, :8],
                             4)
    y2, S2 = ssm.ssd_chunked(x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:],
                             4, init_state=S1)
    y = torch.cat([y1, y2], 1)
    _close(y, want["cont"][0], 1e-5)
    _close(S2, want["cont"][1], 1e-5)
    y_one, S_one = ssm.ssd_chunked(x, dt, A, Bm, Cm, 4)
    _close(y, y_one.numpy(), 1e-5)
    _close(S2, S_one.numpy(), 1e-5)


def test_ssd_chunked_grad_matches_jax():
    """d(sum(y * wy) + sum(S * wS)) by every input against ``jax.grad``:
    finite, within 1e-4 of each input's largest gradient; chunk 8 over
    32 positions, so the log-space mask and the chunk recurrence are
    both differentiated."""
    inputs = _ssd_inputs(1)
    rng = np.random.default_rng(2)
    wy = rng.standard_normal((Bb, L, H, P)).astype(np.float32)
    wS = rng.standard_normal((Bb, H, P, N)).astype(np.float32)

    def jloss(*a):
        y, S = jssm.ssd_chunked(*a, 8)
        return jnp.sum(y * wy) + jnp.sum(S * wS)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, inputs))
    args = [t.requires_grad_(True) for t in _t(*inputs)]
    y, S = ssm.ssd_chunked(*args, 8)
    (y * torch.from_numpy(wy)).sum().add((S * torch.from_numpy(wS)).sum()) \
        .backward()
    for a, w, name in zip(args, want, ("x", "dt", "A", "Bm", "Cm")):
        assert torch.isfinite(a.grad).all(), name
        _close(a.grad, w, 1e-4, f"d/d{name}")


@pytest.mark.parametrize("length,chunk", [(513, 256), (2049, 256)])
def test_ssd_chunked_raises_where_jax_asserts(length, chunk):
    """L // (L // chunk) chunks of equal length cannot cover L: JAX
    asserts (tests/test_ssm.py's oracle is not reached), the port raises
    ValueError naming (L, chunk)."""
    x, dt, A, Bm, Cm = _ssd_inputs(3, length)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    with pytest.raises(ValueError, match=rf"\({length}, {chunk}\)"):
        ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk)


# --------------------------------------------------------------------------
# the conv and the block
# --------------------------------------------------------------------------

def _perturbed(tree, seed):
    """JAX's init as numpy, every constant leaf (conv bias, D_skip,
    dt_bias, the norm) given a small random part."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _block_case(dtype: str):
    """(JAX cfg, the port's cfg, numpy params in ``dtype`` with the f32
    leaves JAX keeps f32, x (2, 12, 128), a decode token and a state)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype,
                              compute_dtype=dtype)
    jdt = jnp.dtype(dtype)
    p = _perturbed(jax.tree.map(np.asarray, jssm.init_mamba2(
        jax.random.PRNGKey(4), jcfg, jnp.float32)), 5)
    p = {k: (v if k in ("A_log", "D_skip", "dt_bias") else jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jdt)), v))
        for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = np.asarray(jnp.asarray(rng.standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)).astype(jdt))
    d_in, nh, n, hd = ssm._dims(cfg)
    st = (np.asarray(jnp.asarray(rng.standard_normal(
        (2, cfg.ssm_conv - 1, d_in + 2 * n)).astype(np.float32)).astype(jdt)),
        (0.1 * rng.standard_normal((2, nh, hd, n))).astype(np.float32))
    return jcfg, cfg, p, x, st


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def block_case(request):
    """JAX's mamba2_block over 12 positions (from no state and from a
    given one, with the states), and mamba2_decode of one more token."""
    jcfg, cfg, p, x, st = _block_case(request.param)

    @jax.jit
    def run(p, x, conv, s):
        y0, st0 = jssm.mamba2_block(p, x, jcfg, return_state=True)
        y1, st1 = jssm.mamba2_block(p, x, jcfg, state=jssm.SSMState(conv, s),
                                    return_state=True)
        yd, std = jssm.mamba2_decode(p, x[:, :1], st1, jcfg)
        return (y0, st0), (y1, st1), (yd, std)
    want = jax.tree.map(np.asarray, run(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(st[0]),
        jnp.asarray(st[1])))
    return request.param, cfg, p, x, st, want


def _check_out(got, want, dtype):
    """f32: within 1e-5 of max|want|; bf16: within 1 bf16 ulp of
    max|want| (2^-7 of the largest value's binade)."""
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, 1e-5)
        return
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want, np.float32)).max())
    assert err <= ulp, (err, ulp)


def test_mamba2_block_matches_jax(block_case):
    dtype, cfg, p, x, st, want = block_case
    tp = to_torch(p)
    assert tp["A_log"].dtype == torch.float32
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        (y0, st0) = ssm.mamba2_block(tp, to_torch(x), c, return_state=True)
        (y1, st1) = ssm.mamba2_block(
            tp, to_torch(x), c, state=ssm.SSMState(*to_torch(list(st))),
            return_state=True)
        for (y, s), (wy, ws) in (((y0, st0), want[0]), ((y1, st1), want[1])):
            _check_out(y, wy, dtype)
            _check_out(s.conv, ws.conv, dtype)
            _close(s.ssm, ws.ssm, 1e-5)
    assert ssm.mamba2_block(tp, to_torch(x), cfg)[1] is None


def test_mamba2_decode_matches_jax(block_case):
    dtype, cfg, p, x, st, want = block_case
    tp = to_torch(p)
    _, st1 = ssm.mamba2_block(tp, to_torch(x), cfg,
                              state=ssm.SSMState(*to_torch(list(st))),
                              return_state=True)
    yd, std = ssm.mamba2_decode(tp, to_torch(x)[:, :1], st1, cfg)
    wy, ws = want[2]
    _check_out(yd, wy, dtype)
    _check_out(std.conv, ws.conv, dtype)
    _close(std.ssm, ws.ssm, 1e-5)


def test_mamba2_prefill_then_decode_equals_full_block():
    """The port's twin of tests/test_ssm.py's
    ``test_mamba_block_prefill_then_decode``: the block over 11
    positions, then one decode step == the block over 12 (atol 1e-4,
    JAX's bound)."""
    _, cfg, p, x, _, = _block_case("float32")
    tp, tx = to_torch(p), to_torch(x)
    y_full, _ = ssm.mamba2_block(tp, tx, cfg)
    _, st = ssm.mamba2_block(tp, tx[:, :-1], cfg, return_state=True)
    y_dec, _ = ssm.mamba2_decode(tp, tx[:, -1:], st, cfg)
    torch.testing.assert_close(y_dec, y_full[:, -1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7 + with_state)
    K, C = 4, 48
    xbc = rng.standard_normal((2, 10, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, C))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    st = rng.standard_normal((2, K - 1, C)).astype(np.float32) \
        if with_state else None
    jst = jnp.asarray(st) if with_state else None
    want, wstate = jax.jit(jssm._causal_conv)(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b), jst)
    got, gstate = ssm._causal_conv(*_t(xbc, w, b), None if st is None
                                   else torch.from_numpy(st))
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(gstate.numpy(), np.asarray(wstate))


def test_init_mamba2_shapes_and_dtypes_match_jax():
    """The port's init at the smoke size, bf16 params, two stacked axes:
    JAX's leaves (shapes and dtypes; A_log, D_skip and dt_bias f32)."""
    jcfg, cfg, _, _, _ = _block_case("bfloat16")
    want = jax.eval_shape(lambda k: jax.vmap(jax.vmap(
        lambda kk: jssm.init_mamba2(kk, jcfg, jnp.bfloat16)))(
            jax.random.split(k, 6).reshape(2, 3, -1)), jax.random.PRNGKey(0))
    got = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, lead=(2, 3))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    from repro_torch.utils import tree_flatten
    gl = tree_flatten(got)[0]
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    np.testing.assert_allclose(
        got["A_log"][1, 2].numpy(),
        np.log(np.linspace(1.0, 16.0, ssm._dims(cfg)[1])), rtol=1e-6)
