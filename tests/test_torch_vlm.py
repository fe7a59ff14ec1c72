"""The vlm family of the port (``repro_torch/models/lm.py``'s vlm branches,
llama-3.2-vision-11b's smoke variant: 4 dense layers in 2 groups, each
followed by a gated cross-attention block into 16 image patches, d_model
128, 4 heads of 32, query chunks of 64) against the JAX package's
``src/repro/models/lm.py``, on the CPU.

Every gate starts at 0 in both packages (``tanh(0) = 0``): a fresh model
ignores its image, and a parity test from that init would pass with the
cross blocks dropped.  So the same numpy weights (JAX's ``init``) go
through both packages with the gates set to values in [0.5, 1) drawn
from a seed and the norm weights perturbed so that they matter; every
served case also shows that a second image moves the logits by more
than its tolerance, in JAX and in the port.  ``repro_torch.convert``
carries the weights over (the f32 gates beside bf16 or f32 weights) and
JAX's ``DecodeCache`` (its ``cross_kv`` included).  JAX runs jitted,
outside any mesh, with its default ``use_pallas=False``, one program per
served case for prefill, loss and the second image's prefill and one for
decode.  The port runs with ``use_pallas=True``, as its launcher builds
the config: on the CPU that resolves to the plain versions.

The served cases: f32 (the decoder's 80 positions past the 64-query
chunk, so the cross attention's plain route runs query chunks at a
negative offset, Sq 80 > Sk 16), bf16, grouped-query attention at 2 kv
heads of 4 (the smoke variant is MHA) and 96 patches against a context
of 40 (Sk > Sq without causality, as llama's 4096 patches against a
shorter prompt).

Tolerances, those of tests/test_torch_encdec.py: ``_cross_block`` (the
memory projected, or its K/V cached) and ``loss_fn`` rel 1e-5 in f32;
prefill and decode logits within 1e-4 of max|logits|, the self and cross
caches within 1e-5 of their max, greedy tokens equal.  In bf16 one cross
block is within 1 bf16 ulp of max; the whole prefill and decode within 6
bf16 ulps of max (eager PyTorch rounds the SwiGLU's ``silu(x wg)`` and
the gated products before the sum where XLA's fused loops round once),
the greedy tokens equal wherever JAX's top two logits are further apart
than twice that, and the loss within twice the logits' tolerance.
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
from repro.models import build_model as jax_build_model
from repro.models import lm as jlm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_torch
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, build_model, lm
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-11b"
B, N_DECODE = 2, 4
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
#: (test id, context length, fields replaced in both smoke configs)
SERVED = [("f32", 80, {}), ("bf16", 80, BF16),
          ("kv2", 80, dict(n_kv_heads=2)),
          ("patches96", 40, dict(n_patches=96))]
#: the whole bf16 prefill and decode against JAX, in bf16 ulps of max
BF16_ULPS = 6


def _configs(**kw):
    """(JAX's, the port's) smoke config with ``kw`` replaced in both; the
    port's with ``use_pallas=True``, as its launcher builds it."""
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), use_pallas=True,
                                **kw))


def _live(tree, seed):
    """A JAX vlm tree (or one cross block's) as numpy, its gates drawn in
    [0.5, 1) and its norm weights (constant leaves) given a small random
    part, each in its own dtype."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name.startswith("gate_"):
            return rng.uniform(0.5, 1.0, x.shape).astype(np.float32)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = (x.astype(np.float32) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(one, tree)


def _np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel_close(got, want, rel, what=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _ulp(want) -> float:
    """One bf16 ulp of max |want|."""
    return 2.0 ** (np.floor(np.log2(np.abs(_np32(want)).max())) - 7)


def _ulps_of_max(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / _ulp(want))


def _tol(cfg, want, logits: bool) -> float:
    """The absolute tolerance of a served comparison against ``want``."""
    if cfg.compute_dtype == "bfloat16":
        return BF16_ULPS * _ulp(want)
    return (1e-4 if logits else 1e-5) * float(np.abs(_np32(want)).max())


# --------------------------------------------------------------------------
# the served cases: JAX's prefill, loss and decode
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SERVED, ids=[i for i, _, _ in SERVED])
def served(request):
    """JAX's loss, prefill and N_DECODE greedy steps of the smoke model
    with ``kw`` and live gates, and the prefill's logits with a second
    image, with the weights and inputs (numpy)."""
    name, ctx, kw = request.param
    jcfg, cfg = _configs(**kw)
    jm = jax_build_model(jcfg)
    params = _live(jm.init(jax.random.PRNGKey(0)), 3)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, ctx)).astype(np.int32)
    cap = ctx + N_DECODE + 1

    @jax.jit
    def first(p, tokens, images):
        batch = {"tokens": tokens, "image_embed": images[0]}
        other = jm.prefill(p, {"tokens": tokens, "image_embed": images[1]},
                           capacity=cap)[0]
        return jm.loss(p, batch)[0], jm.prefill(p, batch, capacity=cap), \
            other
    loss, (logits, cache), other = first(jp, jnp.asarray(prompt),
                                         jnp.asarray(images))
    decode = jax.jit(jm.decode_step)
    out = dict(id=name, ctx=ctx, cfg=cfg, params=params, images=images,
               prompt=prompt, cap=cap, loss=float(loss),
               other=np.asarray(other[:, -1]),
               logits=[np.asarray(logits[:, -1])],
               caches=[jax.tree.map(np.asarray, cache)], tokens=[])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:, :jcfg.vocab_size], -1).astype(
            jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(ctx + i))
        out["logits"].append(np.asarray(logits[:, -1]))
    out["caches"].append(jax.tree.map(np.asarray, cache))
    return out


def _batch(served, image: int = 0) -> dict:
    return {"tokens": torch.from_numpy(served["prompt"]),
            "image_embed": torch.from_numpy(served["images"][image])}


def _port_run(served, use_pallas: bool = True):
    """The port's prefill + decode from the same weights, fed the JAX
    run's greedy tokens; returns (logits per step, own greedy tokens,
    caches after prefill and after the last step)."""
    cfg = dataclasses.replace(served["cfg"], use_pallas=use_pallas)
    model = build_model(cfg)
    params = to_torch(served["params"])
    logits_out, toks, caches = [], [], []
    with torch.inference_mode():
        logits, cache = model.prefill(params, _batch(served),
                                      capacity=served["cap"])
        caches.append(jax.tree.map(lambda t: t.clone(), cache))
        logits_out.append(logits[:, -1])
        for i, jtok in enumerate(served["tokens"]):
            toks.append(logits[:, -1:, :cfg.vocab_size].argmax(-1))
            logits, cache = model.decode_step(
                params, torch.from_numpy(jtok.copy()), cache,
                served["ctx"] + i)
            logits_out.append(logits[:, -1])
    caches.append(cache)
    return logits_out, toks, caches


def _cache_leaves(cache):
    return [cache.kv.k, cache.kv.v, cache.cross_kv.k, cache.cross_kv.v]


def test_prefill_and_decode_match_jax(served):
    cfg = served["cfg"]
    V = cfg.vocab_size
    logits, toks, caches = _port_run(served)
    for i, (got, want) in enumerate(zip(logits, served["logits"])):
        np.testing.assert_allclose(_np32(got[:, :V]), want[:, :V], rtol=0,
                                   atol=_tol(cfg, want[:, :V], True),
                                   err_msg=f"logits {i}")
    for i, (got, want) in enumerate(zip(toks, served["tokens"])):
        if cfg.compute_dtype == "bfloat16":
            # a near tie may split at bf16 tolerance: compare where JAX's
            # top two are further apart than twice the tolerance
            jl = served["logits"][i][:, :V]
            top2 = np.sort(jl, -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * _tol(cfg, jl, True)
            np.testing.assert_array_equal(got.numpy()[clear, 0],
                                          want[clear, 0])
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    groups, every = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every
    for step, (got, want) in enumerate(zip(caches, served["caches"])):
        assert want.ssm == () and want.tail_ssm == ()
        assert tuple(got.kv.k.shape) == (groups, every, B, served["cap"],
                                         cfg.n_kv_heads, cfg.hd)
        assert tuple(got.cross_kv.k.shape) == (groups, B, cfg.n_patches,
                                               cfg.n_kv_heads, cfg.hd)
        for name, g, w in zip(("k", "v", "cross k", "cross v"),
                              _cache_leaves(got), _cache_leaves(want)):
            np.testing.assert_allclose(_np32(g), _np32(w), rtol=0,
                                       atol=_tol(cfg, w, False),
                                       err_msg=f"cache {name} {step}")


def test_image_moves_the_logits(served):
    """A second image moves the prefill's logits by more than the
    comparison's tolerance, in JAX and in the port, and the port's
    logits for it match JAX's: the cross blocks are live."""
    cfg = served["cfg"]
    V = cfg.vocab_size
    first = served["logits"][0][:, :V]
    tol = _tol(cfg, first, True)
    assert np.abs(served["other"][:, :V] - first).max() > 10 * tol
    with torch.inference_mode():
        model = build_model(cfg)
        got, _ = model.prefill(to_torch(served["params"]), _batch(served, 1))
    got = _np32(got[:, -1, :V])
    np.testing.assert_allclose(got, served["other"][:, :V], rtol=0,
                               atol=_tol(cfg, served["other"][:, :V], True))
    assert np.abs(got - first).max() > 10 * tol


def test_loss_matches_jax(served):
    cfg = served["cfg"]
    got = build_model(cfg).loss(to_torch(served["params"]), _batch(served))
    assert got.dtype == torch.float32 and got.dim() == 0
    err = abs(float(got) - served["loss"])
    if cfg.compute_dtype == "bfloat16":
        # a cross-entropy moves by at most twice its logits' error
        assert err <= 2 * _tol(cfg, served["logits"][0][:, :cfg.vocab_size],
                               True)
    else:
        assert err <= 1e-5 * abs(served["loss"])


def test_decode_cache_converts(served):
    """JAX's DecodeCache carries over with its (groups, every, ...) self
    K/V and (groups, ...) cross K/V, bit for bit."""
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
    (JAX's tests/test_decode_consistency.py for the port), with live
    gates: within 1e-4 of max|logits| in f32."""
    _, cfg = _configs()
    model = build_model(cfg)
    params = model.init(1)
    for k in ("gate_attn", "gate_mlp"):
        params["cross"][k] = torch.full_like(params["cross"][k], 0.7)
    rng = np.random.default_rng(9)
    image = torch.from_numpy(rng.standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    ctx = 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        B, ctx + 3)).astype(np.int32))
    with torch.inference_mode():
        _, cache = model.prefill(params, {"image_embed": image,
                                          "tokens": toks[:, :ctx]},
                                 capacity=ctx + 4)
        for i in range(3):
            cur = ctx + i
            dec, cache = model.decode_step(params, toks[:, cur:cur + 1],
                                           cache, cur)
            full, _ = model.prefill(params, {"image_embed": image,
                                             "tokens": toks[:, :cur + 1]})
            _rel_close(dec[..., :cfg.vocab_size],
                       full[..., :cfg.vocab_size], 1e-4, f"step {i}")


# --------------------------------------------------------------------------
# the cross block
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross_ref():
    """JAX's ``_cross_block`` at the smoke widths (GQA at 2 kv heads) in
    f32 and bf16, live gates: 80 queries into 16 patches (the memory
    projected), and one query against the K/V it returned."""
    rng = np.random.default_rng(21)
    out = {}
    for name, kw in (("f32", {}), ("bf16", BF16)):
        jcfg, cfg = _configs(n_kv_heads=2, **kw)
        dt = jnp.dtype(jcfg.compute_dtype)
        p = _live(jax.tree.map(lambda x: x[0], jax_build_model(jcfg).init(
            jax.random.PRNGKey(2))["cross"]), 22)
        x = rng.standard_normal((B, 80, cfg.d_model)).astype(np.float32)
        mem = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)

        @jax.jit
        def both(p, x, mem, x1):
            y, kv = jlm._cross_block(p, x, mem, jcfg)
            y1, _ = jlm._cross_block(p, x1, None, jcfg, kv=kv)
            return y, kv, y1
        args = [jnp.asarray(a).astype(dt) for a in (x, mem, x1)]
        y, kv, y1 = both(jax.tree.map(jnp.asarray, p), *args)
        out[name] = dict(cfg=cfg, p=p, args=[np.asarray(a) for a in args],
                         y=np.asarray(y), kv=jax.tree.map(np.asarray, kv),
                         y1=np.asarray(y1))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_block_matches_jax(cross_ref, dtype, cached):
    r = cross_ref[dtype]
    cfg, tp = r["cfg"], to_torch(r["p"])
    assert tp["gate_attn"].dtype == tp["gate_mlp"].dtype == torch.float32
    x, mem, x1 = (to_torch(a) for a in r["args"])
    with torch.inference_mode():
        if cached:
            got, _ = lm._cross_block(tp, x1, None, cfg, kv=attention.KVCache(
                to_torch(r["kv"].k), to_torch(r["kv"].v)))
            want, inp = r["y1"], x1
        else:
            got, kv = lm._cross_block(tp, x, mem, cfg)
            want, inp = r["y"], x
            for g, w in zip(kv, (r["kv"].k, r["kv"].v)):
                if dtype == "bf16":
                    assert _ulps_of_max(g, w) <= 1
                else:
                    _rel_close(g, w, 1e-5)
        # the block without its gated terms is the input: far from JAX's
        assert np.abs(_np32(inp) - _np32(want)).max() > 10 * _ulp(want)
    assert got.dtype == x.dtype
    if dtype == "bf16":
        assert _ulps_of_max(got, want) <= 1
    else:
        _rel_close(got, want, 1e-5)


# --------------------------------------------------------------------------
# the tree, the caches, the data, the launchers
# --------------------------------------------------------------------------

def test_params_tree_matches_jax():
    """The port's init at the smoke size has JAX's tree (keys, shapes,
    dtypes: the gates f32 zeros of (groups,) in a bf16 tree too); at full
    size, in fake tensors beside JAX's ``eval_shape``, 23 leaves and
    11,520,053,264 parameters (JAX's analytic ``n_params()`` says
    10,446,311,424: it counts a cross block as two attentions and two
    norms, ROADMAP queue 3)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for kw in ({}, BF16):
        jcfg, cfg = _configs(**kw)
        want = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
        got = build_model(cfg).init(0)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = tree_flatten(got)[0]
        assert len(wl) == len(gl) == 23
        for (path, w), g in zip(wl, gl):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        for k in ("gate_attn", "gate_mlp"):
            gate = got["cross"][k]
            assert gate.dtype == torch.float32 and tuple(gate.shape) == (2,)
            assert not gate.any()
    want = jax.eval_shape(jax_build_model(jax_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        got = build_model(get_config(ARCH)).init(0)
        shapes = [tuple(x.shape) for x in tree_flatten(got)[0]]
        dtypes = [x.dtype for x in tree_flatten(got)[0]]
    assert shapes == [w.shape for w in jax.tree.leaves(want)]
    assert [str(d).removeprefix("torch.") for d in dtypes] == \
        [w.dtype.name for w in jax.tree.leaves(want)]
    assert sum(int(np.prod(s)) for s in shapes) == 11_520_053_264
    assert jax_config(ARCH).n_params() == 10_446_311_424
    tree = jax.tree.map(np.asarray, jax_build_model(_configs(**BF16)[0])
                        .init(jax.random.PRNGKey(5)))
    for w, g in zip(jax.tree.leaves(tree), tree_flatten(to_torch(tree))[0]):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_layers", [4, 2])
def test_stacked_mask_matches_jax(n_layers):
    """Every leaf under ``blocks`` and ``cross`` (the gates included) is
    stacked, as JAX's mask says; ``embed``, ``final_norm`` and
    ``lm_head`` are not."""
    jcfg, cfg = _configs(n_layers=n_layers)
    jm = jax_build_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = jax.tree.leaves(jm.stacked_mask(jp))
    model = build_model(cfg)
    params = model.init(0)
    got = tree_flatten(model.stacked_mask(params))[0]
    assert got == want
    tops = [path[0] for path, _ in jax.tree_util.tree_flatten_with_path(
        jp)[0]]
    assert got == [t.key in ("blocks", "cross") for t in tops]
    assert sum(got) == 20


def test_init_cache_matches_jax():
    jcfg, cfg = _configs(n_kv_heads=2)
    want = jax_build_model(jcfg).init_cache(B, 40)
    got = build_model(cfg).init_cache(B, 40)
    assert got.ssm == () and got.tail_ssm == ()
    for g, w in zip(_cache_leaves(got), _cache_leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()


@pytest.mark.parametrize("n_shards,shard", [(1, 0), (2, 1)])
def test_batch_with_aux_bit_for_bit(n_shards, shard):
    """``TokenPipeline.batch_with_aux`` against JAX's: the tokens and the
    (local_batch, n_patches, d_model) f32 patches, bit for bit."""
    jcfg, cfg = _configs()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=17, global_batch=4,
              seed=3, n_shards=n_shards, shard=shard)
    for step in (0, 5):
        want = JTokenPipeline(**kw).batch_with_aux(step, jcfg)
        got = TokenPipeline(**kw).batch_with_aux(step, cfg)
        assert set(got) == set(want) == {"tokens", "image_embed"}
        assert got["image_embed"].dtype == torch.float32
        assert tuple(got["image_embed"].shape) == (4 // n_shards, 16, 128)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_config_takes_whole_groups_only():
    """A vlm whose ``cross_attn_every`` is 0 or does not divide
    ``n_layers`` raises, where JAX's reshape to (groups, every, ...)
    fails; ``cut_depth`` keeps whole groups only, through that check."""
    base = dict(name="v", family="vlm", n_layers=4, d_model=64, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=256, n_patches=8)
    ModelConfig(**base, cross_attn_every=2)
    for every in (0, 3):
        with pytest.raises(ValueError, match="cross_attn_every"):
            ModelConfig(**base, cross_attn_every=every)
    assert train_cli.cut_depth(get_config(ARCH), 5).n_layers == 5
    with pytest.raises(ValueError, match="cross_attn_every"):
        train_cli.cut_depth(get_config(ARCH), 6)


def test_serve_load_draws_the_image_and_cuts_whole_groups():
    """``serve.load`` draws the (batch, n_patches, d_model) image after
    the prompt from the seed-7 generator; ``n_layers`` cuts the depth to
    whole groups only."""
    model, params, batch = serve.load(ARCH, True, 2, 8, "cpu")
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(batch["tokens"], torch.randint(0, 512, (2, 8),
                                                      generator=gen))
    assert torch.equal(batch["image_embed"], torch.randn(
        (2, 16, 128), generator=gen))
    model, params, _ = serve.load(ARCH, True, 2, 8, "cpu", n_layers=2)
    assert tuple(params["blocks"]["attn"]["wq"]["w"].shape) == (1, 2, 128,
                                                                128)
    assert tuple(params["cross"]["gate_mlp"].shape) == (1,)
    with pytest.raises(ValueError, match="cross_attn_every"):
        serve.load(ARCH, True, 2, 8, "cpu", n_layers=3)
