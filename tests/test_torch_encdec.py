"""The encoder-decoder family of the port (``repro_torch/models/encdec.py``,
seamless-m4t-large-v2's smoke variant: 2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, query chunks of 64) against the JAX package's
``src/repro/models/encdec.py``, on the CPU.

The same numpy weights (JAX's ``init``, with its constant leaves — the
norm weights — perturbed so that they matter) go through both packages;
``repro_torch.convert`` carries them over, and carries JAX's
``DecodeCache`` (its ``cross_kv`` included).  JAX runs jitted, outside
any mesh, with its default ``use_pallas=False`` (its jnp path; its
Pallas flash kernel does not trace on this JAX), one program per
served case.  The port runs with ``use_pallas=True``, as its launcher
builds the config: on the CPU that resolves to the plain versions.  The
source has 24 frames and the decoder's context 80 positions, past the
64-query chunk, so the cross attention's plain route runs query chunks
at a negative offset (Sq 80 > Sk 24).

Tolerances, those of tests/test_torch_serve.py in f32: ``encode``,
``cross_attention_block`` (memory projected, or its K/V cached) and
``loss_fn`` rel 1e-5; prefill and decode logits within 1e-4 of
max|logits|, the self and cross caches within 1e-5 of their max, greedy
tokens equal.  In bf16 one block (the encoder's attention, the cross
attention either way) is within 1 bf16 ulp of max; the whole prefill and
decode within 6 bf16 ulps of max (caches and logits): eager PyTorch
rounds the SwiGLU's ``silu(x wg)`` before the product where XLA's fused
loop rounds once, 1 ulp of max per MLP (measured), and 4 layers of
residual stream carry it on; there the greedy tokens are held equal
wherever JAX's top two logits are further apart than that tolerance,
and the loss within twice the logits' tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import TokenPipeline as JTokenPipeline
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, encdec, lm
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
B, S_ENC, CTX, N_DECODE = 2, 24, 80, 4
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
#: (test id, fields replaced in both smoke configs)
SERVED = [("f32", {}), ("bf16", BF16), ("window16", dict(sliding_window=16))]
#: the whole bf16 prefill and decode against JAX, in bf16 ulps of max
BF16_ULPS = 6


def _configs(**kw):
    """(JAX's, the port's) smoke config with ``kw`` replaced in both; the
    port's with ``use_pallas=True``, as its launcher builds it."""
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), use_pallas=True,
                                **kw))


def _perturbed(tree, seed):
    """The JAX init tree as numpy, every constant leaf given a small
    random part (in its own dtype)."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = (x.astype(np.float32) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel_close(got, want, rel, what=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _ulps_of_max(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _inputs(cfg):
    rng = np.random.default_rng(4)
    src = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, CTX)).astype(np.int32)
    return src, prompt


# --------------------------------------------------------------------------
# the served cases: JAX's encode, loss, prefill and decode in one program
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SERVED, ids=[i for i, _ in SERVED])
def served(request):
    """JAX's encoder memory, loss, prefill and N_DECODE greedy steps of
    the smoke model with ``kw``, with the weights and inputs (numpy)."""
    _, kw = request.param
    jcfg, cfg = _configs(**kw)
    jm = jax_build_model(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(0)), 3)
    jp = jax.tree.map(jnp.asarray, params)
    src, prompt = _inputs(cfg)
    cap = CTX + N_DECODE + 1
    window = jcfg.sliding_window or None

    @jax.jit
    def first(p, batch):
        memory = jencdec.encode(p, batch["src_embed"], jcfg, window=window)
        return memory, jm.loss(p, batch)[0], jm.prefill(p, batch,
                                                        capacity=cap)
    batch = {"src_embed": jnp.asarray(src), "tokens": jnp.asarray(prompt)}
    memory, loss, (logits, cache) = first(jp, batch)
    decode = jax.jit(jm.decode_step)
    out = dict(id=request.param[0], cfg=cfg, params=params, src=src,
               prompt=prompt, cap=cap, memory=np.asarray(memory),
               loss=float(loss), logits=[np.asarray(logits[:, -1])],
               caches=[jax.tree.map(np.asarray, cache)], tokens=[])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:, :jcfg.vocab_size], -1).astype(
            jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(CTX + i))
        out["logits"].append(np.asarray(logits[:, -1]))
    out["caches"].append(jax.tree.map(np.asarray, cache))
    return out


def _port_run(served, use_pallas: bool = True):
    """The port's prefill + decode from the same weights, fed the JAX
    run's greedy tokens; returns (logits per step, own greedy tokens,
    caches after prefill and after the last step)."""
    cfg = dataclasses.replace(served["cfg"], use_pallas=use_pallas)
    model = build_model(cfg)
    params = to_torch(served["params"])
    logits_out, toks, caches = [], [], []
    with torch.inference_mode():
        logits, cache = model.prefill(
            params, {"src_embed": torch.from_numpy(served["src"]),
                     "tokens": torch.from_numpy(served["prompt"])},
            capacity=served["cap"])
        caches.append(jax.tree.map(lambda t: t.clone(), cache))
        logits_out.append(logits[:, -1])
        for i, jtok in enumerate(served["tokens"]):
            toks.append(logits[:, -1:, :cfg.vocab_size].argmax(-1))
            logits, cache = model.decode_step(
                params, torch.from_numpy(jtok.copy()), cache, CTX + i)
            logits_out.append(logits[:, -1])
    caches.append(cache)
    return logits_out, toks, caches


def _cache_leaves(cache):
    return [cache.kv.k, cache.kv.v, cache.cross_kv.k, cache.cross_kv.v]


def _close(served, got, want, what):
    if served["cfg"].compute_dtype == "bfloat16":
        u = _ulps_of_max(got, want)
        assert u <= BF16_ULPS, f"{what}: {u} bf16 ulps of max"
    else:
        _rel_close(got, want, 1e-4 if what.startswith("logits") else 1e-5,
                   what)


def test_prefill_and_decode_match_jax(served):
    logits, toks, caches = _port_run(served)
    V = served["cfg"].vocab_size
    for i, (got, want) in enumerate(zip(logits, served["logits"])):
        _close(served, got[:, :V], want[:, :V], f"logits {i}")
    bf16 = served["cfg"].compute_dtype == "bfloat16"
    for i, (got, want) in enumerate(zip(toks, served["tokens"])):
        if bf16:
            # a near tie may split at bf16 tolerance: compare where JAX's
            # top two are further apart than the tolerance, twice
            jl = served["logits"][i][:, :V]
            top2 = np.sort(jl, -1)[:, -2:]
            ulp = 2.0 ** (np.floor(np.log2(np.abs(jl).max())) - 7)
            clear = top2[:, 1] - top2[:, 0] > 2 * BF16_ULPS * ulp
            np.testing.assert_array_equal(got.numpy()[clear, 0],
                                          want[clear, 0])
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    for step, (got, want) in enumerate(zip(caches, served["caches"])):
        assert want.ssm == () and want.tail_ssm == ()
        for name, g, w in zip(("k", "v", "cross k", "cross v"),
                              _cache_leaves(got), _cache_leaves(want)):
            _close(served, g, w, f"cache {name} {step}")


def test_encode_matches_jax(served):
    cfg = served["cfg"]
    with torch.inference_mode():
        got = encdec.encode(to_torch(served["params"]),
                            torch.from_numpy(served["src"]), cfg,
                            window=cfg.sliding_window or None)
    assert got.dtype == getattr(torch, cfg.compute_dtype)
    if served["id"] == "bf16":
        assert _ulps_of_max(got, served["memory"]) <= BF16_ULPS
    else:
        _rel_close(got, served["memory"], 1e-5)


def test_loss_matches_jax(served):
    got = build_model(served["cfg"]).loss(
        to_torch(served["params"]),
        {"src_embed": torch.from_numpy(served["src"]),
         "tokens": torch.from_numpy(served["prompt"])})
    assert got.dtype == torch.float32 and got.dim() == 0
    err = abs(float(got) - served["loss"])
    if served["id"] == "bf16":
        # a cross-entropy moves by at most twice its logits' error
        lmax = np.abs(served["logits"][0][:, :served["cfg"].vocab_size]).max()
        ulp = 2.0 ** (np.floor(np.log2(lmax)) - 7)
        assert err <= 2 * BF16_ULPS * ulp
    else:
        assert err <= 1e-5 * abs(served["loss"])


def test_decode_cache_converts(served):
    """JAX's DecodeCache carries over with its cross K/V, bit for bit."""
    want = served["caches"][0]
    got = to_torch(want)
    assert isinstance(got, lm.DecodeCache) and got.ssm == ()
    for g, w in zip(_cache_leaves(got), _cache_leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np32(g), _np32(w))


def test_use_pallas_on_cpu_is_bit_identical(served):
    """On the CPU the kernel route resolves to the plain versions: the
    same tensors, bit for bit."""
    on, off = _port_run(served, True), _port_run(served, False)
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for ca, cb in zip(on[2], off[2]):
        for a, b in zip(_cache_leaves(ca), _cache_leaves(cb)):
            assert torch.equal(a, b)


def test_prefill_and_decode_equal_the_full_forward():
    """Prefill of the context, then decode of token i, gives the logits a
    prefill of the context and tokens 0 ... i gives at its last position
    (JAX's tests/test_decode_consistency.py for the port): within 1e-4
    of max|logits| in f32."""
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(1)
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        B, CTX + 3)).astype(np.int32))
    with torch.inference_mode():
        _, cache = model.prefill(params, {"src_embed": src,
                                          "tokens": toks[:, :CTX]},
                                 capacity=CTX + 4)
        assert tuple(cache.cross_kv.k.shape) == (2, B, 16, 4, 32)
        for i in range(3):
            cur = CTX + i
            dec, cache = model.decode_step(params, toks[:, cur:cur + 1],
                                           cache, cur)
            full, _ = model.prefill(params, {"src_embed": src,
                                             "tokens": toks[:, :cur + 1]})
            _rel_close(dec[..., :cfg.vocab_size],
                       full[..., :cfg.vocab_size], 1e-4, f"step {i}")


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross_ref():
    """JAX's cross attention at the smoke widths in f32 and bf16: the
    memory projected (Sq 80 against 24 frames, the plain route's query
    chunks at a negative offset) and one query against its cached K/V."""
    rng = np.random.default_rng(21)
    out = {}
    for name, kw in (("f32", {}), ("bf16", BF16)):
        jcfg, cfg = _configs(**kw)
        dt = jnp.dtype(jcfg.compute_dtype)
        p = _perturbed(jattn.init_cross_attn(jax.random.PRNGKey(2), jcfg,
                                             dt), 22)
        x = rng.standard_normal((B, CTX, cfg.d_model)).astype(np.float32)
        mem = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(
            np.float32)
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)

        @jax.jit
        def both(p, x, mem, x1):
            y, kv = jattn.cross_attention_block(p, x, mem, jcfg)
            y1, _ = jattn.cross_attention_block(p, x1, None, jcfg, kv=kv)
            return y, kv, y1
        args = [jnp.asarray(a).astype(dt) for a in (x, mem, x1)]
        y, kv, y1 = both(jax.tree.map(jnp.asarray, p), *args)
        out[name] = dict(cfg=cfg, p=p, args=[np.asarray(a) for a in args],
                         y=np.asarray(y), kv=jax.tree.map(np.asarray, kv),
                         y1=np.asarray(y1))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_block_matches_jax(cross_ref, dtype, cached):
    r = cross_ref[dtype]
    cfg, tp = r["cfg"], to_torch(r["p"])
    x, mem, x1 = (to_torch(a) for a in r["args"])
    with torch.inference_mode():
        if cached:
            got, kv = attention.cross_attention_block(
                tp, x1, None, cfg, kv=attention.KVCache(
                    to_torch(r["kv"].k), to_torch(r["kv"].v)))
            want = r["y1"]
        else:
            got, kv = attention.cross_attention_block(tp, x, mem, cfg)
            want = r["y"]
            for g, w in zip(kv, (r["kv"].k, r["kv"].v)):
                if dtype == "bf16":
                    assert _ulps_of_max(g, w) <= 1
                else:
                    _rel_close(g, w, 1e-5)
    assert got.dtype == x.dtype
    if dtype == "bf16":
        assert _ulps_of_max(got, want) <= 1
    else:
        _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_attention_block_matches_jax(dtype):
    """The encoder's self attention (``causal=False``, rotary positions
    0 ... S - 1) over 80 positions, two query chunks: rel 1e-5 in f32,
    1 bf16 ulp of max in bf16."""
    jcfg, cfg = _configs(**({} if dtype == "f32" else BF16))
    dt = jnp.dtype(jcfg.compute_dtype)
    p = _perturbed(jattn.init_attn(jax.random.PRNGKey(5), jcfg, dt), 23)
    x = jnp.asarray(np.random.default_rng(24).standard_normal(
        (B, CTX, cfg.d_model)).astype(np.float32)).astype(dt)
    want, _ = jax.jit(lambda p, x: jattn.attention_block(
        p, x, jcfg, causal=False))(jax.tree.map(jnp.asarray, p), x)
    got, _ = attention.attention_block(to_torch(p), to_torch(np.asarray(x)),
                                       cfg, causal=False)
    if dtype == "bf16":
        assert _ulps_of_max(got, want) <= 1
    else:
        _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_non_causal_beyond_sk_matches_jax_reference(window, use_kernel):
    """Sq 40 > Sk 12 without causality, queries at offset Sk - Sq < 0,
    through ``ops.attention`` (``use_kernel`` on the CPU resolves to the
    plain version) against JAX's ``mha_reference``: rel 1e-5; a window
    of 16 masks by JAX's one-sided ``kpos > qpos - w``."""
    rng = np.random.default_rng(31)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 3, 40, 32), (2, 3, 12, 32), (2, 3, 12, 32)))
    want = jref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, window=window)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                        window=window, use_kernel=use_kernel)
    _rel_close(got, want, 1e-5)


def test_window_reaches_the_encoder_and_not_the_cross_attention():
    """With ``sliding_window`` 16 the encoder's output over 24 frames
    changes and the cross attention's does not (JAX passes it no
    window)."""
    _, cfg = _configs()
    wcfg = dataclasses.replace(cfg, sliding_window=16)
    params = build_model(cfg).init(2)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(
        (B, CTX, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        plain = encdec.encode(params, src, cfg)
        windowed = encdec.encode(params, src, wcfg, window=16)
        assert not torch.allclose(plain, windowed)
        cp = lm._layer(params["dec_blocks"], 0)["cross"]
        a, _ = attention.cross_attention_block(cp, x, plain, cfg)
        b, _ = attention.cross_attention_block(cp, x, plain, wcfg)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the tree, the data, the launcher
# --------------------------------------------------------------------------

def test_params_tree_matches_jax():
    """The port's init at the smoke size has JAX's tree (keys, shapes,
    dtypes); at full size, in fake tensors beside JAX's ``eval_shape``,
    27 leaves and 1,279,850,496 parameters; a bf16 JAX tree carries over
    bit for bit."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for kw in ({}, BF16):
        jcfg, cfg = _configs(**kw)
        want = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
        got = build_model(cfg).init(0)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = tree_flatten(got)[0]
        assert len(wl) == len(gl) == 27
        for (path, w), g in zip(wl, gl):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
    want = jax.eval_shape(jax_build_model(jax_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        got = build_model(get_config(ARCH)).init(0)
        shapes = [tuple(x.shape) for x in tree_flatten(got)[0]]
    assert shapes == [w.shape for w in jax.tree.leaves(want)]
    assert sum(int(np.prod(s)) for s in shapes) == 1_279_850_496
    tree = jax.tree.map(np.asarray, jax_build_model(_configs(**BF16)[0])
                        .init(jax.random.PRNGKey(5)))
    for w, g in zip(jax.tree.leaves(tree), tree_flatten(to_torch(tree))[0]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_stacked_mask_marks_no_leaf_as_jax():
    """JAX's registry gives the encoder-decoder ``lm.stacked_mask``,
    which marks only ``blocks``/``cross``/``tail``: no encdec leaf is
    stacked, so each (layers, ...) leaf compresses as one row."""
    jm = jax_build_model(_configs()[0])
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = jax.tree.leaves(jm.stacked_mask(jp))
    model = build_model(_configs()[1])
    got = tree_flatten(model.stacked_mask(model.init(0)))[0]
    assert got == want and not any(got)


def test_init_cache_matches_jax():
    jcfg, cfg = _configs()
    want = jax_build_model(jcfg).init_cache(B, 40, s_enc=S_ENC)
    got = build_model(cfg).init_cache(B, 40, s_enc=S_ENC)
    for g, w in zip(_cache_leaves(got), _cache_leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()


@pytest.mark.parametrize("n_shards,shard", [(1, 0), (2, 1)])
def test_batch_with_aux_bit_for_bit(n_shards, shard):
    """``TokenPipeline.batch_with_aux`` against JAX's: the tokens and the
    (local_batch, seq_len, d_model) f32 source frames, bit for bit; a
    decoder-only config gets the tokens alone."""
    jcfg, cfg = _configs()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=17, global_batch=4,
              seed=3, n_shards=n_shards, shard=shard)
    for step in (0, 5):
        want = JTokenPipeline(**kw).batch_with_aux(step, jcfg)
        got = TokenPipeline(**kw).batch_with_aux(step, cfg)
        assert set(got) == set(want) == {"tokens", "src_embed"}
        assert got["src_embed"].dtype == torch.float32
        assert tuple(got["src_embed"].shape) == (4 // n_shards, 17, 128)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    dense = get_smoke_config("qwen1.5-4b")
    got = TokenPipeline(**kw).batch_with_aux(5, dense)
    assert set(got) == {"tokens"}
    assert torch.equal(got["tokens"], TokenPipeline(**kw).batch(5)["tokens"])


def test_serve_load_draws_frames_and_refuses_n_layers():
    """``serve.load`` draws the 32 source frames after the prompt from the
    seed-7 generator; cutting ``n_layers`` raises for an
    encoder-decoder."""
    model, params, batch = serve.load(ARCH, True, 2, 8, "cpu")
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(batch["tokens"], torch.randint(0, 512, (2, 8),
                                                      generator=gen))
    assert torch.equal(batch["src_embed"], torch.randn(
        (2, serve.SRC_FRAMES, 128), generator=gen))
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.load(ARCH, True, 2, 8, "cpu", n_layers=1)
