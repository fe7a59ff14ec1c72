"""Serving in the port (prefill, then greedy decode) against the JAX
package, on the CPU, for the smoke variants of qwen1.5-4b, rwkv6-1.6b,
the two MoE configs (granite-moe-1b-a400m, qwen3-moe-30b-a3b) and the
hybrid zamba2-7b (5 layers: 2 groups of 2 Mamba2 layers, each followed
by the shared attention block, and 1 tail layer); for grouped-query
attention: qwen1.5-4b's and granite's smoke variants at 2 and 1 kv heads
of their 4 query heads (the smoke variants themselves are MHA); for a
pure Mamba2 model (zamba2's smoke widths as ``family="ssm"``, 2
layers); and for zamba2's smoke at ``ssm_chunk`` 16 (the prefill's SSD
scan over 6 chunks) and at ``sliding_window`` 16 (windowed prefill and
decode of the shared block).

The same numpy weights (the JAX initialisers' draw, with the leaves JAX
initialises to constants — QKV biases, LoRA B, norm weights, decay and
mix vectors — perturbed so that they matter) go through both packages;
``repro_torch.convert`` carries them over.  JAX runs jitted and outside
any mesh, with its default ``use_pallas=False`` (its jnp path), as
tests/test_decode_consistency.py runs it.  The port runs with
``use_pallas=True``, as its launcher builds the config: on the CPU that
resolves to the plain versions.

Tolerances: the RWKV time and channel mix atol 1e-4 (JAX's own
kernel-vs-scan bound); attention blocks rel 1e-5 of max|out|; prefill
and decode logits within 1e-4 of max|logits|, KV caches and RWKV states
within 1e-5 of their max|.|, greedy tokens equal; ``use_pallas`` on or
off on the CPU bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import rwkv as jrwkv
from repro.configs import ARCH_CONFIGS as JAX_ARCH_CONFIGS
from repro.configs import smoke_variant as jax_smoke_variant
from repro_torch.configs import ARCH_CONFIGS, get_smoke_config
from repro_torch.configs.base import ModelConfig, smoke_variant
from repro_torch.convert import to_torch
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, rwkv

torch.set_num_threads(2)

ARCHS = ("qwen1.5-4b", "rwkv6-1.6b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b", "zamba2-7b")
#: a pure Mamba2 model: zamba2-7b's smoke widths as the ``ssm`` family
MAMBA2 = dict(family="ssm", name="mamba2-x", n_layers=2, shared_attn_every=0)
#: (test id, arch, fields replaced in both smoke configs): every arch,
#: grouped-query attention at 2 and 1 kv heads, the pure Mamba2 model,
#: the hybrid at chunk 16 and windowed
SERVED = [(a, a, {}) for a in ARCHS] + [
    (f"{a}-kv{n}", a, dict(n_kv_heads=n))
    for a in ("qwen1.5-4b", "granite-moe-1b-a400m") for n in (2, 1)] + [
    ("mamba2-x", "zamba2-7b", MAMBA2),
    ("zamba2-7b-chunk16", "zamba2-7b", dict(ssm_chunk=16)),
    ("zamba2-7b-window16", "zamba2-7b", dict(sliding_window=16))]
B, N_DECODE = 2, 4


def _configs(arch, **kw):
    """(JAX's, the port's) smoke config of ``arch`` with ``kw`` replaced
    in both."""
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _perturbed(tree, seed):
    """The JAX init tree as numpy, every constant leaf (zeros, ones, the
    0.5 mixes, the -2 decay base) given a small random part."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _rel_close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_rwkv_time_and_channel_mix_match_jax_scan():
    cfg = get_smoke_config("rwkv6-1.6b")
    jcfg = jax_smoke_config("rwkv6-1.6b")
    p = _perturbed(jrwkv.init_rwkv6(jax.random.PRNGKey(1), jcfg,
                                    jnp.float32), 11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    H, hd = cfg.d_model // cfg.hd, cfg.hd
    st = [rng.standard_normal((2, cfg.d_model)).astype(np.float32),
          rng.standard_normal((2, cfg.d_model)).astype(np.float32),
          (0.1 * rng.standard_normal((2, H, hd, hd))).astype(np.float32)]
    jst = jrwkv.RWKVState(*map(jnp.asarray, st))
    jy, jst1 = jax.jit(lambda p, x, s: jrwkv.time_mix(p, x, jcfg, s))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jst)
    jc, jst2 = jax.jit(jrwkv.channel_mix)(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x), jst1)
    tp = to_torch(p)
    tst = rwkv.RWKVState(*map(torch.from_numpy, st))
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        ty, tst1 = rwkv.time_mix(tp, torch.from_numpy(x), c, tst)
        tc, tst2 = rwkv.channel_mix(tp, torch.from_numpy(x), tst1)
        for got, want in ((ty, jy), (tc, jc), *zip(tst2, jst2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("S", [16, 80])
def test_attention_blocks_match_jax(S):
    """attention_block (S = 80 runs the query chunks of 64) and
    decode_attention_block, qwen1.5-4b smoke with its QKV bias."""
    cfg = get_smoke_config("qwen1.5-4b")
    jcfg = jax_smoke_config("qwen1.5-4b")
    assert cfg.qkv_bias and jcfg.attn_chunk == cfg.attn_chunk == 64
    p = _perturbed(jattn.init_attn(jax.random.PRNGKey(2), jcfg,
                                   jnp.float32), 21)
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jout, jkv = jax.jit(lambda p, x: jattn.attention_block(p, x, jcfg))(
        jp, jnp.asarray(x))
    tout, tkv = attention.attention_block(tp, torch.from_numpy(x), cfg)
    _rel_close(tout, jout, 1e-5)
    _rel_close(tkv.k, jkv.k, 1e-5)
    _rel_close(tkv.v, jkv.v, 1e-5)

    cap, cur = S + 8, S + 3
    k = (rng.standard_normal((2, cap, cfg.n_kv_heads, cfg.hd))
         ).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jc = jax.jit(lambda p, x, c, n: jattn.decode_attention_block(
        p, x, c, n, jcfg))(jp, jnp.asarray(x1),
                           jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                           jnp.int32(cur))
    tout, tc = attention.decode_attention_block(
        tp, torch.from_numpy(x1), attention.KVCache(
            torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
        cur, cfg)
    _rel_close(tout, jout, 1e-5)
    _rel_close(tc.k, jc.k, 1e-5)
    _rel_close(tc.v, jc.v, 1e-5)


# --------------------------------------------------------------------------
# the slice: prefill + decode of both smoke models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SERVED, ids=[i for i, _, _ in SERVED])
def served(request):
    """JAX's prefill + N_DECODE greedy steps of one smoke model, with the
    weights, prompt and the JAX results (numpy)."""
    _, arch, kw = request.param
    jcfg, cfg = _configs(arch, **kw)
    jm = jax_build_model(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(0)), 3)
    jp = jax.tree.map(jnp.asarray, params)
    # attention: a context past attn_chunk (and 6 SSD chunks of 16)
    ctx = 40 if cfg.name.startswith("rwkv") else 96
    cap = ctx + N_DECODE + 1
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, ctx)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, capacity=cap))(jp, jnp.asarray(prompt))
    decode = jax.jit(jm.decode_step)
    out = dict(arch=arch, cfg=cfg, params=params, prompt=prompt, cap=cap,
               logits=[np.asarray(logits[:, -1])],
               caches=[jax.tree.map(np.asarray, cache)], tokens=[])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(ctx + i))
        out["logits"].append(np.asarray(logits[:, -1]))
    out["caches"].append(jax.tree.map(np.asarray, cache))
    return out


def _port_run(served, use_pallas: bool):
    """The port's prefill + decode from the same weights, fed the JAX
    run's greedy tokens; returns (logits per step, own greedy tokens,
    caches after prefill and after the last step)."""
    cfg = dataclasses.replace(served["cfg"], use_pallas=use_pallas)
    model = build_model(cfg)
    params = to_torch(served["params"])
    ctx = served["prompt"].shape[1]
    logits_out, toks, caches = [], [], []
    with torch.inference_mode():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(served["prompt"])},
            capacity=served["cap"])
        caches.append(jax.tree.map(lambda t: t.clone(), cache))
        logits_out.append(logits[:, -1])
        for i, jtok in enumerate(served["tokens"]):
            toks.append(logits[:, -1:].argmax(-1))
            logits, cache = model.decode_step(
                params, torch.from_numpy(jtok.copy()), cache, ctx + i)
            logits_out.append(logits[:, -1])
    caches.append(cache)
    return logits_out, toks, caches


def _cache_leaves(cache):
    """The KV cache's k and v, then the states' leaves (a hybrid's tail
    last), of a JAX or a port cache."""
    out = [cache.kv.k, cache.kv.v] if cache.kv != () else []
    for st in (cache.ssm, cache.tail_ssm):
        out += list(st)
    return out


def test_prefill_and_decode_match_jax(served):
    logits, toks, caches = _port_run(served, use_pallas=True)
    V = served["cfg"].vocab_size
    for got, want in zip(logits, served["logits"]):
        _rel_close(got[:, :V], want[:, :V], 1e-4)
    for got, want in zip(toks, served["tokens"]):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(caches, served["caches"]):
        jl = _cache_leaves(want)
        assert len(jl) == len(_cache_leaves(got))
        for g, w in zip(_cache_leaves(got), jl):
            assert tuple(g.shape) == w.shape
            _rel_close(g, w, 1e-5)


def test_use_pallas_on_cpu_is_bit_identical(served):
    """On the CPU the kernel route resolves to the plain versions, which
    are what the jnp route computes: the same tensors, bit for bit."""
    on, off = _port_run(served, True), _port_run(served, False)
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for ca, cb in zip(on[2], off[2]):
        for a, b in zip(_cache_leaves(ca), _cache_leaves(cb)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    """``Model.loss`` of every smoke model (the dense one with its QKV
    bias, RWKV-6 with fresh states per layer, the MoE ones as ce + the
    layers' aux, the hybrid's groups, shared block and tail) against
    JAX's, outside any mesh: rel 1e-5."""
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(6)), 7)
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    want, parts = jax.jit(jm.loss)(jax.tree.map(jnp.asarray, params),
                                   {"tokens": jnp.asarray(tokens)})
    got = build_model(get_smoke_config(arch)).loss(
        to_torch(params), {"tokens": torch.from_numpy(tokens)})
    assert (float(parts["aux"]) > 0) == (jcfg.family == "moe")
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_bf16_params_convert_bit_for_bit():
    cfg = dataclasses.replace(jax_smoke_config("qwen1.5-4b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(cfg).init(jax.random.PRNGKey(5)))
    got = to_torch(tree)
    leaves = jax.tree.leaves(tree)
    assert all(x.dtype.name == "bfloat16" for x in leaves)
    for w, g in zip(leaves, jax.tree.leaves(got)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))
    assert got["blocks"]["attn"]["wq"]["b"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the launcher and the config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("seamless-m4t-large-v2",
                                         "llama-3.2-vision-11b"))
def test_serve_cli_runs_on_cpu(arch):
    res = serve.main(["--device", "cpu", "--arch", arch, "--smoke",
                      "--batch", "2", "--ctx", "32", "--gen", "4"])
    assert res["tokens"].shape == (2, 4)
    assert res["logits"].shape == (4, 2, 512)
    assert torch.isfinite(res["logits"]).all()
    assert res["peak_memory_bytes"] == 0 and res["device"] == "cpu"


def test_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke", "--batch", "1",
                    "--ctx", "8", "--gen", "2"])


@pytest.mark.parametrize("kw", [dict(family="vlm", n_layers=3,
                                     cross_attn_every=2),
                                dict(family="rnn")])
def test_config_refuses_what_is_not_ported(kw):
    base = dict(name="x", family="dense", n_layers=1, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=256)
    with pytest.raises(ValueError):
        ModelConfig(**{**base, **kw})


@pytest.mark.parametrize("arch", sorted(ARCH_CONFIGS))
def test_arch_config_equals_jax(arch):
    """Every ported arch config and paper-lm-100m's ``LM_100M_CONFIG``,
    and each one's smoke variant, equals the JAX package's field for
    field over the fields both define (every field of the port's),
    ``remat`` and ``kv_cache_dtype`` included; paper-lm-100m's free-text
    ``citation`` names the JAX package's own end-to-end script, and the
    port words it apart."""
    fields = [f.name for f in dataclasses.fields(ModelConfig)]
    jfields = {f.name for f in dataclasses.fields(JAX_ARCH_CONFIGS[arch])}
    assert set(fields) <= jfields, set(fields) - jfields
    full, smoke = ARCH_CONFIGS[arch], smoke_variant(ARCH_CONFIGS[arch])
    jfull = JAX_ARCH_CONFIGS[arch]
    skip = ("citation",) if arch == "paper-lm-100m" else ()
    for mine, theirs in ((full, jfull), (smoke, jax_smoke_variant(jfull))):
        for f in fields:
            if f not in skip:
                assert getattr(mine, f) == getattr(theirs, f), \
                    (arch, f, getattr(mine, f), getattr(theirs, f))
