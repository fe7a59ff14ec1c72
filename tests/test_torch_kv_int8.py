"""The int8 KV cache of the port (``kv_cache_dtype="int8"``) against the
JAX package, on the CPU.

* ``quantize_kv`` / ``dequantize_kv`` against jitted JAX, bit for bit
  (codes, scales, dequantized values), in f32 and bf16, on rows built to
  land on exact .5 ties, an all-zero row (scale 1e-30, codes 0), rows
  holding +-amax (codes +-127) and random rows at several magnitudes;
* the scale rule: jitted JAX computes ``amax * f32(1/127) + 1e-30`` as
  one fused multiply-add, rounded once (held against exact rationals);
  eager JAX divides by 127 and differs in some f32 rows, the product
  rounded before the sum differs in some bf16 rows; the port follows
  jitted JAX;
* ``decode_attention_block`` against an int8 cache in f32 and bf16 (the
  dequantized cache rounded to the compute dtype, as JAX rounds it);
* prefill + 4 greedy decode steps (each from JAX's cache of the step
  before) of the int8 smoke of the dense
  (qwen1.5-4b), MoE (granite-moe-1b-a400m), hybrid (zamba2-7b),
  encoder-decoder (seamless-m4t-large-v2) and vlm (llama-3.2-vision-11b,
  gates live) families against JAX's, from the same weights (JAX's
  draw, its constant leaves perturbed, as tests/test_torch_serve.py
  does); positions past the prompt hold code 0 and scale 0 in both;
  the cross K/V stay in the compute dtype;
* the RWKV smoke, which has no KV cache, serves the same bits with and
  without the field.

Each section runs ONE jitted JAX program per case (the serving
section: one prefill and one decode step, compiled once).  Tolerances:
the codec bit for bit; serving: equal greedy tokens, logits within 1e-4
of max|logits|, cache codes within 1 step and scales within 1e-5 of
their max (the K/V inputs differ by ulps between the packages, which
can move a quotient across a rounding boundary), the cross K/V within
1e-5 of max.
"""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.models import attention, build_model

torch.set_num_threads(2)

HD = 32
B, CTX, N_DECODE = 2, 40, 4
#: the five families with a self-attention cache: (arch, the batch's
#: extra input and its length)
SERVED = [("qwen1.5-4b", None), ("granite-moe-1b-a400m", None),
          ("zamba2-7b", None), ("seamless-m4t-large-v2", "src_embed"),
          ("llama-3.2-vision-11b", "image_embed")]


def _np_dtype(name):
    return np.float32 if name == "float32" else ml_dtypes.bfloat16


def _f32_nearest(v: Fraction) -> np.float32:
    """The f32 nearest the exact value ``v`` (ties to even)."""
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.array(c).view(np.int32)) & 1))


def _scale_of(amax) -> np.ndarray:
    """The scale of each row's absmax by jitted JAX's rule: ``amax *
    f32(1/127) + 1e-30`` with the product and the sum rounded once to
    f32 (a fused multiply-add), worked out in exact rationals."""
    c, t = Fraction(float(np.float32(1) / np.float32(127))), \
        Fraction(float(np.float32(1e-30)))
    a = np.asarray(amax, np.float32)
    return np.array([_f32_nearest(Fraction(float(x)) * c + t)
                     for x in a.reshape(-1)], np.float32).reshape(a.shape)


def _tie_rows(rng, dtype) -> np.ndarray:
    """Rows whose quotients x / scale are exact .5 ties: absmax 127 *
    2^-e puts the scale at 2^-e exactly, and (n + 0.5) * 2^-e is exact
    in bf16 as in f32 for n < 127."""
    rows = []
    for e in (3, 7, 12):
        A = np.float32(127 * 2.0 ** -e)
        s = _scale_of(A)
        assert s == np.float32(2.0 ** -e)
        n = rng.integers(-127, 127, HD).astype(np.float32)
        row = (n + np.float32(0.5)) * s
        row[0] = A
        assert np.all(row.astype(dtype).astype(np.float32) == row)
        q = row[1:] / s
        assert np.all(q - np.floor(q) == 0.5)
        rows.append(row)
    return np.stack(rows)


def _codec_rows(dtype) -> np.ndarray:
    """(2, 24, 4, HD) K/V values, the last axis one quantized row each:
    ties, a zero row, rows holding +amax and -amax, tiny rows, random
    rows over eight decades."""
    rng = np.random.default_rng(31)
    ties = _tie_rows(rng, dtype)
    zero = np.zeros((1, HD), np.float32)
    pm = (0.5 * rng.standard_normal((2, HD))).astype(np.float32)
    pm[0, :2] = [3.0, -3.0]
    pm[1, 5], pm[1, 9] = -7.25, 7.25
    mags = 10.0 ** rng.integers(-4, 4, (192 - 10, 1))
    rand = (rng.standard_normal((192 - 10, HD)) * mags).astype(np.float32)
    # absmax near 1e-30 * 2^24: the 1e-30 moves the scale by several ulps
    tiny = (rng.standard_normal((4, HD)) * 10.0 ** np.array(
        [[-28], [-25], [-23], [-21]])).astype(np.float32)
    rows = np.concatenate([ties, zero, pm, tiny, rand])
    return rows.astype(dtype).reshape(2, 24, 4, HD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_jitted_jax(dtype):
    x = _codec_rows(_np_dtype(dtype))

    def codec(x):
        q, s = jattn.quantize_kv(x)
        return q, s, jattn.dequantize_kv(q, s, x.dtype)
    jq, js, jd = map(np.asarray, jax.jit(codec)(jnp.asarray(x)))
    tx = to_torch(x)
    q, s = attention.quantize_kv(tx)
    d = attention.dequantize_kv(q, s, tx.dtype)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:-1] + (1,) and d.dtype == tx.dtype
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy().view(np.int32), js.view(np.int32))
    np.testing.assert_array_equal(
        d.view(torch.int16).numpy() if dtype == "bfloat16"
        else d.numpy().view(np.int32),
        jd.view(np.int16 if dtype == "bfloat16" else np.int32))
    rows, codes = x.reshape(-1, HD), jq.reshape(-1, HD)
    np.testing.assert_array_equal(
        js.reshape(-1), _scale_of(np.abs(rows.astype(np.float32)).max(-1)))
    # the ties rounded half to even, the zero row, +-amax at +-127
    n = np.floor(rows[:3, 1:].astype(np.float32) /
                 js.reshape(-1)[:3, None])
    np.testing.assert_array_equal(codes[:3, 1:], n + (n % 2 != 0))
    assert js.reshape(-1)[3] == np.float32(1e-30) and not codes[3].any()
    assert list(codes[4, :2]) == [127, -127]
    assert codes[5, 5] == -127 and codes[5, 9] == 127
    assert np.abs(codes).max() == 127


def test_scale_follows_jitted_not_eager_jax():
    """Over 2048 (position, head) rows of each dtype, jitted
    ``quantize_kv`` gives ``amax * f32(1/127) + 1e-30`` rounded once in
    every row.  In f32 eager JAX's true division by 127 differs in some
    rows; in bf16 (absmax of 8 bits, so the exact product often lies
    halfway between two f32 values) the product rounded before the sum
    differs in some.  The port gives jitted JAX's bits in every row."""
    rng = np.random.default_rng(32)
    inv = np.float32(1) / np.float32(127)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        x = rng.standard_normal((2, 256, 4, HD)).astype(dtype)
        jitted = np.asarray(jax.jit(jattn.quantize_kv)(jnp.asarray(x))[1])
        amax = np.abs(x.astype(np.float32)).max(-1, keepdims=True)
        np.testing.assert_array_equal(jitted, _scale_of(amax))
        if dtype == np.float32:
            eager = np.asarray(jattn.quantize_kv(jnp.asarray(x))[1])
            np.testing.assert_array_equal(
                eager, amax / np.float32(127) + np.float32(1e-30))
            assert (eager != jitted).any()
        else:
            assert ((amax * inv + np.float32(1e-30)) != jitted).any()
        got = attention.quantize_kv(to_torch(x))[1].numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      jitted.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_block_int8_matches_jax(dtype):
    """``decode_attention_block`` against an int8 cache (qwen1.5-4b smoke
    widths with its QKV bias; 40 of 48 positions filled, the new token
    at 40) against jitted JAX.  The dequantized cache is rounded to the
    compute dtype before the f32 einsums, as JAX rounds it: in bf16 the
    output is within 1 bf16 ulp of each of JAX's values (attending the
    f32 products instead moves some by over 100), in f32 within 1e-5 of
    max; the new codes equal JAX's, the scales bit for bit."""
    npd = _np_dtype(dtype)
    kw = dict(kv_cache_dtype="int8", param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke_config("qwen1.5-4b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"), **kw)
    p = jax.tree.map(lambda x: x.astype(npd), _perturbed(
        jattn.init_attn(jax.random.PRNGKey(2), jcfg, jnp.float32), 21))
    rng = np.random.default_rng(33)
    S, cur, H = 48, 40, cfg.n_kv_heads
    kv = (rng.standard_normal((2, 2, S, H, HD))
          * np.arange(1, S + 1)[:, None, None] / S).astype(np.float32)
    kv[:, :, cur:] = 0.0
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(npd)

    def block(p, x, kv, n):
        (kq, ks), (vq, vs) = (jattn.quantize_kv(t) for t in kv)
        return jattn.decode_attention_block(
            p, x, jattn.KVCache(kq, vq, ks, vs), n, jcfg)
    jout, jc = jax.jit(block)(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jnp.asarray(kv), jnp.int32(cur))
    jc = jax.tree.map(np.asarray, jc)
    cache = to_torch(jc)
    for t in cache:                  # the new token's slot as before it
        t[:, cur] = 0
    out, got = attention.decode_attention_block(to_torch(p), to_torch(x),
                                                cache, cur, cfg)
    want = np.asarray(jout).astype(np.float32)
    out = out.float().numpy()
    if dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(out - want) <= ulp)
    else:
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_array_equal(got.k.numpy(), jc.k)
    np.testing.assert_array_equal(got.v.numpy(), jc.v)
    np.testing.assert_array_equal(got.k_scale.numpy(), jc.k_scale)
    np.testing.assert_array_equal(got.v_scale.numpy(), jc.v_scale)


# --------------------------------------------------------------------------
# serving with the int8 cache: the five families against JAX
# --------------------------------------------------------------------------

def _perturbed(tree, seed):
    """JAX's init tree as numpy, every constant leaf given a small random
    part; a vlm's gates (0 at init) drawn in [0.5, 1)."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        x = np.asarray(x)
        if str(path[-1]).strip("[]'").startswith("gate_"):
            return rng.uniform(0.5, 1.0, x.shape).astype(np.float32)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.fixture(scope="module", params=SERVED, ids=[a for a, _ in SERVED])
def served(request):
    return _jax_serve(*request.param)


def _jax_serve(arch, extra):
    """JAX's int8 prefill + N_DECODE greedy steps of one smoke model."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), kv_cache_dtype="int8")
    jm = jax_build_model(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(0)), 3)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, CTX))
             .astype(np.int32)}
    if extra:
        n = jcfg.n_patches if extra == "image_embed" else 32
        batch[extra] = rng.standard_normal((B, n, jcfg.d_model)).astype(
            np.float32)
    cap = CTX + N_DECODE + 1
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, capacity=cap))(
        jp, jax.tree.map(jnp.asarray, batch))
    decode = jax.jit(jm.decode_step)
    out = dict(arch=arch, params=params, batch=batch, cap=cap,
               logits=[np.asarray(logits[:, -1])],
               caches=[jax.tree.map(np.asarray, cache)], tokens=[])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(CTX + i))
        out["logits"].append(np.asarray(logits[:, -1]))
        out["caches"].append(jax.tree.map(np.asarray, cache))
    return out


def _check_cache(got, want, filled):
    """The port's cache against JAX's: int8 codes within 1 step, f32
    scales within 1e-5 of their max, code 0 and scale 0 from position
    ``filled`` on; the cross K/V in the compute dtype within 1e-5 of
    max."""
    kv, jkv = got.kv, want.kv
    assert kv.quantized and jkv.quantized
    for g, w in zip(kv, jkv):
        assert tuple(g.shape) == w.shape and g.dtype == {
            np.int8: torch.int8, np.float32: torch.float32}[w.dtype.type]
    for g, w in ((kv.k, jkv.k), (kv.v, jkv.v)):
        assert np.abs(g.numpy().astype(np.int32) - w).max() <= 1
        assert not g[..., filled:, :, :].any()
    for g, w in ((kv.k_scale, jkv.k_scale), (kv.v_scale, jkv.v_scale)):
        tol = 1e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
        assert not g[..., filled:, :, :].any()
        assert not w[..., filled:, :, :].any()
    if got.cross_kv != ():
        assert not got.cross_kv.quantized
        for g, w in zip(got.cross_kv[:2], want.cross_kv[:2]):
            assert g.dtype == torch.float32
            tol = 1e-5 * float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def test_int8_serving_matches_jax(served):
    """The port's prefill, then each decode step from JAX's cache of the
    step before (free running, a K/V value an ulp apart can round to the
    next code, and its 1/127 of the row's absmax moves every later step
    by ~1e-4 of max|logits|: as the trainer tests take each round from
    the reference's state)."""
    cfg = dataclasses.replace(get_smoke_config(served["arch"]),
                              kv_cache_dtype="int8", use_pallas=True)
    model = build_model(cfg)
    params = to_torch(served["params"])
    batch = {k: torch.from_numpy(v) for k, v in served["batch"].items()}
    V = cfg.vocab_size
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, capacity=served["cap"])
        for i in range(N_DECODE + 1):
            want = served["logits"][i][:, :V]
            np.testing.assert_allclose(
                logits[:, -1, :V].numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()))
            _check_cache(cache, served["caches"][i], CTX + i)
            if i == N_DECODE:
                break
            jtok = served["tokens"][i]
            np.testing.assert_array_equal(
                logits[:, -1:].argmax(-1).numpy(), jtok)
            logits, cache = model.decode_step(
                params, torch.from_numpy(jtok.copy()),
                to_torch(served["caches"][i]), CTX + i)


def test_rwkv_ignores_the_field():
    """RWKV-6 has no KV cache: the int8 field serves the same bits."""
    base = get_smoke_config("rwkv6-1.6b")
    runs = []
    for kv in ("", "int8"):
        model = build_model(dataclasses.replace(base, kv_cache_dtype=kv,
                                                use_pallas=True))
        params = model.init(0)
        tokens = torch.randint(0, base.vocab_size, (B, CTX),
                               generator=torch.Generator().manual_seed(5))
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": tokens},
                                          capacity=CTX + 2)
            tok = logits[:, -1:].argmax(-1)
            logits2, cache = model.decode_step(params, tok, cache, CTX)
        runs.append((logits, logits2, cache))
    (a1, a2, ac), (b1, b2, bc) = runs
    assert ac.kv == () == bc.kv
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    for x, y in zip(ac.ssm, bc.ssm):
        assert torch.equal(x, y)
