"""The adaptive compression budget of the port against the JAX package:
the gamma controller, the theory-safe step scale, the ragged wire rows
and their per-row codec, the ``perleaf`` and ``bucketed`` exchanges at a
per-round gamma_t, single-node CSGD-ASSS under each schedule, the train
CLI, the exchange's byte counts at paper-lm-100m's widths, and
benchmarks/collective_bytes.py's per-step bytes for every ported config.

The JAX side runs jitted, as its trainer runs it; the exchange in a
1-device ``shard_map`` (as tests/test_torch_wire.py runs it), its EF ops
in Pallas interpret mode.  The port runs its plain versions on the CPU.
Inputs come from numpy seeds.

Tolerances: gamma_t, the step scale, payload words, decoded values and
indices, updates, EF memory and every byte count bit for bit.  Telemetry
ratios within rel 1e-5 (f32 sums over whole leaves in another order).
CSGD-ASSS at tests/test_torch_csgd.py's tolerances: alpha, n_evals,
gamma_t, eta and bytes equal, loss rel 1e-5, parameters within 1e-5 of
the leaf's max |p| (forward and backward sum in other orders).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.comm import wire as jwire
from repro.configs import get_config as jax_config
from repro.configs import paper_models as jpm
from repro.core import ArmijoConfig as JArmijo
from repro.core import Compressor as JCompressor
from repro.core import CSGDConfig as JCSGDConfig
from repro.core import compression as jcomp
from repro.core import csgd_asss as jcsgd_asss
from repro.core import gamma as jgamma
from repro.core import telemetry as jtel
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.data import synthetic as jsyn
from repro.models import build_model
from repro_torch.comm import bucket, exchange, wire
from repro_torch.configs import paper_models as pm
from repro_torch.convert import to_torch
from repro_torch.core import compression, gamma
from repro_torch.core import telemetry as ttel
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.csgd import CSGDConfig, csgd_asss
from repro_torch.core.dcsgd import plan_wire_bytes, worker_compress_aggregate
from repro_torch.core.leafmath import per_layer_topk
from repro_torch.models import lm
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


# ---------------------------------------------------------------------------
# the gamma controller
# ---------------------------------------------------------------------------

COMPS = {
    "block_topk-budget-0.1": dict(gamma=0.01, method="block_topk",
                                  max_gamma=0.1),
    "topk-budget-0.05-v8": dict(gamma=0.02, method="topk", max_gamma=0.05,
                                value_bits=8),
    "block_topk-fixed": dict(gamma=0.01, method="block_topk"),
}
CONTROLLERS = {
    "fixed": dict(schedule="fixed"),
    "linear-7": dict(schedule="linear", ramp_steps=7),
    "linear-13-floor": dict(schedule="linear", ramp_steps=13,
                            gamma_min=0.005),
    "armijo": dict(schedule="armijo-coupled"),
    "armijo-floor": dict(schedule="armijo-coupled", gamma_min=0.004,
                         grow=1.3),
    "ef": dict(schedule="ef-coupled"),
    "ef-cos": dict(schedule="ef-coupled", ef_target=0.2, ef_band=0.1,
                   cos_floor=0.5),
}


def _driven_telemetry(rounds=20):
    """Per-round search and compression telemetry: random values, the
    ef-coupled band's edges exactly, a NaN and an inf backlog."""
    rng = np.random.default_rng(4)
    backlog = rng.uniform(0.0, 0.4, rounds).astype(f32)
    backlog[2], backlog[3] = f32(0.15 + 0.08), f32(0.15 - 0.08)
    backlog[5], backlog[9] = np.nan, np.inf
    cosine = rng.uniform(-0.3, 1.0, rounds).astype(f32)
    alpha = rng.uniform(0.01, 0.2, rounds).astype(f32)
    alpha[7] = alpha[6] * f32(0.5)               # the collapse edge
    n_evals = rng.integers(1, 6, rounds).astype(f32)
    ema = rng.uniform(0.5, 4.5, rounds).astype(f32)
    ema[11] = f32(3.0)
    return backlog, cosine, alpha, n_evals, ema


@pytest.mark.parametrize("ctrl", CONTROLLERS)
@pytest.mark.parametrize("comp", COMPS)
def test_gamma_update_matches_jitted_jax(comp, ctrl):
    """20 controller rounds from the same telemetry: every gamma_t equal
    bit for bit to the jitted JAX package's."""
    jc, tc = JCompressor(**COMPS[comp]), Compressor(**COMPS[comp])
    jcfg = jgamma.GammaControllerConfig(**CONTROLLERS[ctrl])
    tcfg = gamma.GammaControllerConfig(**CONTROLLERS[ctrl])

    @jax.jit
    def jround(g, step, s_tel, c_tel):
        return jgamma.gamma_update(jcfg, jc, g, step, search=s_tel,
                                   compression=c_tel)

    jg = jgamma.gamma_init(jcfg, jc)
    tg = gamma.gamma_init(tcfg, tc)
    assert _bits(jg) == _bits(tg)
    backlog, cosine, alpha, n_evals, ema = _driven_telemetry()
    seen = set()
    for t in range(20):
        prev = alpha[t - 1] if t else f32(0.1)
        jg = jround(jg, jnp.int32(t),
                    jtel.SearchTelemetry(alpha=alpha[t], alpha_prev=prev,
                                         n_evals=n_evals[t],
                                         n_evals_ema=ema[t]),
                    jtel.CompressionTelemetry(
                        ef_backlog=backlog[t], cosine=cosine[t],
                        decode_error=f32(0.0), eff_gamma=f32(1.0)))
        tg = gamma.gamma_update(
            tcfg, tc, tg, t,
            search=ttel.SearchTelemetry(alpha=alpha[t], alpha_prev=prev,
                                        n_evals=n_evals[t],
                                        n_evals_ema=ema[t]),
            compression=ttel.CompressionTelemetry(
                ef_backlog=backlog[t], cosine=cosine[t],
                decode_error=f32(0.0), eff_gamma=f32(1.0)))
        assert isinstance(tg, np.float32)
        assert _bits(jg) == _bits(tg), (t, float(jg), float(tg))
        seen.add(float(tg))
    if ctrl != "fixed" and COMPS[comp].get("max_gamma"):
        assert len(seen) > 2, seen           # the schedule moved gamma_t


def test_gamma_controller_resolve_errors_match_jax():
    for pkg in (jgamma, gamma):
        with pytest.raises(ValueError, match="hysteresis band"):
            pkg.GammaControllerConfig(schedule="ef-coupled", ef_target=0.1,
                                      ef_band=0.1)
        with pytest.raises(ValueError, match="unknown gamma schedule"):
            pkg.GammaControllerConfig(schedule="cosine")
    for jc, tc in ((JCompressor(max_gamma=0.1), Compressor(max_gamma=0.1)),
                   (JCompressor(gamma=0.01), Compressor(gamma=0.01))):
        for kw in (dict(gamma_min=0.5), dict(gamma_min=0.05,
                                             gamma_max=0.02)):
            with pytest.raises(ValueError, match="exceeds the resolved") \
                    as je:
                jgamma.GammaControllerConfig(**kw).resolve(jc)
            with pytest.raises(ValueError, match="exceeds the resolved") \
                    as te:
                gamma.GammaControllerConfig(**kw).resolve(tc)
            assert str(je.value).split(":")[0] == str(te.value).split(":")[0]
    cfg = dict(gamma0=0.3, gamma_max=0.2)
    assert jgamma.GammaControllerConfig(**cfg).resolve(
        JCompressor(max_gamma=0.1)) == gamma.GammaControllerConfig(
            **cfg).resolve(Compressor(max_gamma=0.1))


@pytest.mark.parametrize("theory_safe", [False, True])
def test_scale_for_matches_jitted_jax(theory_safe):
    """eta = scale_for(gamma_t) * alpha, bit for bit, with the clamp to
    zeta(gamma_t) = sigma*gamma/(2-gamma) on and off."""
    ja, ta = JArmijo(theory_safe=theory_safe), \
        ArmijoConfig(theory_safe=theory_safe)
    jeta = jax.jit(lambda g, a: ja.scale_for(g) * a)
    rng = np.random.default_rng(2)
    gammas = np.concatenate([[0.001, 0.0125, 0.04, 0.07, 0.1, 0.5, 1.0],
                             rng.uniform(0.001, 0.2, 20)]).astype(f32)
    for g in gammas:
        alpha = f32(rng.uniform(0.01, 1.0))
        want = jeta(jnp.float32(g), jnp.float32(alpha))
        got = ta.scale_for(g) * alpha
        assert _bits(want) == _bits(got), (g, float(want), float(got))
        if theory_safe:
            assert _bits(jax.jit(ja.zeta)(jnp.float32(g))) == \
                _bits(ta.zeta(g))
    assert ta.scale_for(None) == f32(ta.a_scale)


# ---------------------------------------------------------------------------
# the budget and the ragged wire row
# ---------------------------------------------------------------------------

def test_budget_counts_match_jax():
    """k_for / block_k at the budget, k_t / k_b_t at a round's gamma_t
    (f32 product, half to even, clamped into [1, budget])."""
    for kw in (dict(method="block_topk", gamma=0.01, max_gamma=0.1),
               dict(method="topk", gamma=0.02, max_gamma=0.05),
               dict(method="block_topk", gamma=0.04, block=512)):
        jc, tc = JCompressor(**kw), Compressor(**kw)
        assert (jc.adaptive, jc.geometry_gamma, jc.block_k()) == \
            (tc.adaptive, tc.geometry_gamma, tc.block_k())
        for gt in (0.0, 0.0004, 0.01, 0.0125, 0.04, 0.0625, 0.07, 0.1,
                   0.3):
            assert int(jc.block_k_t(jnp.float32(gt))) == tc.block_k_t(
                f32(gt)), (kw, gt)
            for d in (999, 1000, 2048, 3000, 70000, 12_582_912):
                assert jc.k_for(d) == tc.k_for(d)
                assert int(jc.k_t_for(d, jnp.float32(gt))) == \
                    tc.k_t_for(d, f32(gt)), (kw, gt, d)


SPEC_COMPS = [dict(method="block_topk", gamma=0.01, max_gamma=0.1),
              dict(method="block_topk", gamma=0.02, max_gamma=0.05,
                   block=512, value_bits=8),
              dict(method="topk", gamma=0.02, max_gamma=0.05,
                   value_bits=4),
              dict(method="topk", gamma=0.01, max_gamma=0.1,
                   value_bits=16),
              dict(method="block_topk", gamma=0.01, value_bits=8)]


@pytest.mark.parametrize("kw", SPEC_COMPS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_wirespec_fields_and_effective_bytes_match_jax(kw):
    jc, tc = JCompressor(**kw), Compressor(**kw)
    for d in (2048, 3000, 70000, 100_000, 589_824):
        js, ts = jwire.WireSpec.for_row(jc, d), wire.WireSpec.for_row(tc, d)
        for f in ("k", "d", "value_bits", "index_bits", "local", "block",
                  "k_b", "ragged", "header_words", "index_words",
                  "value_words", "row_words", "row_bytes"):
            assert getattr(js, f) == getattr(ts, f), (d, f)
        if not ts.ragged:
            continue
        for f in ("count_period", "n_blocks", "full_count"):
            assert getattr(js, f) == getattr(ts, f), (d, f)
        assert ts.effective_row_bytes(ts.full_count) == ts.row_bytes
        for c in sorted({0, 1, 2, 5, ts.full_count // 3,
                         ts.full_count - 1, ts.full_count}):
            assert float(js.effective_row_bytes(c)) == \
                ts.effective_row_bytes(c), (d, c)
            assert int(js.valid_entries(c)) == ts.valid_entries(c)


def test_ragged_block_topk_needs_block_local_rows():
    kw = dict(method="block_topk", gamma=0.01, max_gamma=0.1,
              block=1 << 17)
    for pkg, comp in ((jwire, JCompressor(**kw)), (wire, Compressor(**kw))):
        with pytest.raises(ValueError, match="block-local"):
            pkg.WireSpec.for_row(comp, 1 << 20)


def _rows(kw, L=5, d=3000, seed=0):
    """(vals, idx) wire rows of an (L, d) leaf with ties and a zero row,
    from both packages' selection (held equal here)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((L, d)) * 3).astype(np.float32)
    x[1] = 0.0
    jc, tc = JCompressor(**kw), Compressor(**kw)
    if kw["method"] == "block_topk":
        jv, ji = jcomp.block_extract_sparse(jnp.asarray(x), jc)
        tv, ti = compression.block_extract_sparse(torch.from_numpy(x), tc)
    else:
        k = tc.k_for(d)
        _, ji = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
        ji = ji.astype(jnp.int32)
        jv = jnp.take_along_axis(jnp.asarray(x), ji, axis=1)
        tv, ti = per_layer_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    return jc, tc, (jv, ji), (tv, ti)


@pytest.mark.parametrize("value_bits", [4, 8, 16, 32])
@pytest.mark.parametrize("method", ["block_topk", "topk"])
def test_encode_decode_rows_match_jax(method, value_bits):
    """The per-row codec (the ragged kernels' path) bit for bit, at
    counts that differ per row (0, the full count and between); decode
    also of rows whose header says less than the payload holds, or a
    hostile count past the full one or below zero."""
    kw = dict(method=method, gamma=0.02, max_gamma=0.05,
              value_bits=value_bits)
    jc, tc, (jv, ji), (tv, ti) = _rows(kw)
    spec = wire.WireSpec.for_row(tc, 3000)
    jspec = jwire.WireSpec.for_row(jc, 3000)
    full = spec.full_count
    counts = np.array([0, full, full // 2, 1, full - 1], np.int32)
    jpay = jax.jit(lambda v, i, c: jwire.encode_rows(v, i, jspec,
                                                     counts=c))(
        jv, ji, jnp.asarray(counts))
    tpay = wire.encode_rows(tv, ti, spec, counts=torch.from_numpy(counts))
    np.testing.assert_array_equal(np.asarray(jpay),
                                  tpay.numpy().view(np.uint32))
    exchange.check_payload(tpay, spec, tc, 3000)
    jdec = jax.jit(lambda p: jwire.decode_rows(p, jspec))
    for header in (counts, counts // 2,
                   np.array([full + 5, -1, 3, 0, full], np.int32)):
        words = tpay.numpy().copy()
        words[:, 0] = header
        (jvals, jidx), (tvals, tidx) = jdec(
            jnp.asarray(words.view(np.uint32))), wire.decode_rows(
                torch.from_numpy(words), spec)
        np.testing.assert_array_equal(np.asarray(jvals), tvals.numpy())
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    # all-valid rows decode to what the quantizer gives the valid values
    words = tpay.numpy().copy()
    words[:, 0] = full
    vals, idx = wire.decode_rows(torch.from_numpy(words), spec)
    np.testing.assert_array_equal(idx.numpy()[counts == full],
                                  ti.numpy()[counts == full])


@pytest.mark.parametrize("value_bits", [4, 8, 16, 32])
def test_ragged_bucket_codec_matches_jax(value_bits):
    """The bucketed transport's stream codec on ragged lanes: the same
    payload words as JAX's, each row decoded at its own count."""
    kw = dict(gamma=0.01, max_gamma=0.05, method="block_topk", block=512,
              min_compress_size=64, value_bits=value_bits)
    jc, tc = JCompressor(**kw), Compressor(**kw)
    shapes, stacked = [(3, 2048), (3000,), (50,), (2, 1200)], \
        [True, False, False, True]
    tplan = bucket.build_bucket_plan(shapes, stacked, tc)
    from repro.comm import bucket as jbucket
    jplan = jbucket.build_bucket_plan(shapes, stacked, jc)
    rng = np.random.default_rng(value_bits)
    jrows, trows = [None] * 4, [None] * 4
    for ln in tplan.leaves:
        if ln.dense:
            continue
        x = np.round(rng.standard_normal((ln.L, ln.d)) * 3).astype(
            np.float32)
        jv, ji = jcomp.block_extract_sparse(jnp.asarray(x), jc)
        tv, ti = compression.block_extract_sparse(torch.from_numpy(x), tc)
        c = rng.integers(0, ln.spec.full_count + 1, ln.L).astype(np.int32)
        jrows[ln.index] = (jv, ji, jnp.asarray(c))
        trows[ln.index] = (tv, ti, torch.from_numpy(c))
    jpay = jax.jit(lambda r: jbucket.encode_buckets(jplan, r))(jrows)
    tpay = bucket.encode_buckets(tplan, trows)
    np.testing.assert_array_equal(np.asarray(jpay),
                                  tpay.numpy().view(np.uint32))
    jdec = jbucket.decode_buckets(jplan, jnp.stack([jpay, jpay]))
    tdec = bucket.decode_buckets(tplan, torch.stack([tpay, tpay]))
    for a, b in zip(jdec, tdec):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy())
        np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())


# ---------------------------------------------------------------------------
# the exchange at a round's gamma_t: perleaf, bucketed, JAX
# ---------------------------------------------------------------------------

def _tree(seed):
    """tests/test_torch_wire.py's tree: stacked, flat, dense and large
    leaves."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((3, 2048)).astype(np.float32),
        "b": rng.standard_normal((3000,)).astype(np.float32),
        "tiny": rng.standard_normal((50,)).astype(np.float32),
        "c": rng.standard_normal((2, 4, 300)).astype(np.float32),
        "big": rng.standard_normal((70000,)).astype(np.float32),
    }


def _jax_exchange(tree, mem, eta, comp, gamma_t, transport):
    mesh = jax.make_mesh((1,), ("data",))
    spec = jax.tree.map(lambda _: P(), tree)
    f = shard_map(
        lambda g, m, e, gt: jwca(g, m, e, comp, ("data",), gamma_t=gt,
                                 transport=transport),
        mesh=mesh, in_specs=(spec, spec, P(), P()),
        out_specs=(spec, spec, P(), P(), P()), axis_names={"data"})
    return jax.jit(f)(tree, mem, jnp.float32(eta), jnp.float32(gamma_t))


EXCHANGE_CASES = {
    "block_topk-v32": dict(gamma=0.01, max_gamma=0.1, method="block_topk",
                           min_compress_size=64),
    "block_topk-512-v8": dict(gamma=0.01, max_gamma=0.1,
                              method="block_topk", block=512,
                              min_compress_size=64, value_bits=8),
    "topk-v16": dict(gamma=0.01, max_gamma=0.1, method="topk",
                     min_compress_size=64, value_bits=16),
}


@functools.lru_cache(maxsize=None)
def _inputs():
    tree = _tree(0)
    rng = np.random.default_rng(1)
    mem = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    return tree, mem


@pytest.mark.parametrize("gamma_t", [0.01, 0.04, 0.1])
@pytest.mark.parametrize("case", EXCHANGE_CASES)
def test_worker_compress_aggregate_adaptive_matches_jax(case, gamma_t):
    """Both transports of the port against both of JAX's at max_gamma 0.1
    and a round's gamma_t: updates, EF memory, wire and effective bytes
    bit for bit, telemetry rel 1e-5; and the port's two transports equal
    each other in every output, telemetry included."""
    kw = EXCHANGE_CASES[case]
    tree, mem = _inputs()
    eta, gt = f32(0.7), f32(gamma_t)
    out = {tp: worker_compress_aggregate(
        to_torch(tree), to_torch(mem), eta, Compressor(**kw), gamma_t=gt,
        transport=tp) for tp in ("perleaf", "bucketed")}
    for i in range(5):
        a, b = out["perleaf"][i], out["bucketed"][i]
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), (i, k)
        elif i == 4:
            for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            assert _bits(a) == _bits(b), i
    for tp in ("perleaf", "bucketed"):
        j_upd, j_mem, j_wire, j_eff, j_tel = _jax_exchange(
            tree, mem, eta, JCompressor(**kw), gt, tp)
        t_upd, t_mem, t_wire, t_eff, t_tel = out[tp]
        for name in tree:
            np.testing.assert_array_equal(np.asarray(j_upd[name]),
                                          t_upd[name].numpy(),
                                          err_msg=f"{tp} {name}")
            np.testing.assert_array_equal(np.asarray(j_mem[name]),
                                          t_mem[name].numpy(),
                                          err_msg=f"{tp} {name}")
        assert float(j_wire) == float(t_wire)
        assert float(j_eff) == float(t_eff)
        for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
            np.testing.assert_allclose(float(getattr(j_tel, f)),
                                       float(getattr(t_tel, f)), rtol=1e-5,
                                       err_msg=f"{tp} {f}")
    wire_b, eff_b = out["perleaf"][2], out["perleaf"][3]
    assert (eff_b < wire_b) == (gamma_t < 0.1)


def test_adaptive_default_gamma_t_is_the_compressors():
    kw = EXCHANGE_CASES["block_topk-v32"]
    tree, mem = _inputs()
    a = worker_compress_aggregate(to_torch(tree), to_torch(mem), f32(0.7),
                                  Compressor(**kw), transport="perleaf")
    b = worker_compress_aggregate(to_torch(tree), to_torch(mem), f32(0.7),
                                  Compressor(**kw), gamma_t=f32(0.01),
                                  transport="perleaf")
    assert _bits(a[3]) == _bits(b[3])
    for k in tree:
        assert torch.equal(a[0][k], b[0][k])


def test_unknown_transport_is_refused_everywhere():
    from repro_torch.comm import transport
    from repro_torch.configs.base import OptimizerConfig
    assert transport.transport_names() == ("bucketed", "faulty", "gossip",
                                           "overlap", "perleaf")
    with pytest.raises(ValueError, match="unknown transport 'star'"):
        OptimizerConfig(transport="star")
    tree, mem = _inputs()
    with pytest.raises(ValueError, match="unknown transport"):
        worker_compress_aggregate(to_torch(tree), to_torch(mem), 0.7,
                                  Compressor(), transport="ring")


# ---------------------------------------------------------------------------
# the bytes at paper-lm-100m's widths, from shapes
# ---------------------------------------------------------------------------

#: one worker's exchange bytes a step at max_gamma 0.1 (k_b 102):
#: value bits -> (static, {gamma_t: effective})
LM_BYTES = {32: (65_879_384, {0.01: 6_528_344, 0.04: 26_527_064,
                              0.07: 46_525_784, 0.1: 65_879_384}),
            8: (32_978_608, {0.01: 3_303_088, 0.04: 13_302_448,
                             0.07: 23_301_808, 0.1: 32_978_608})}


def _lm_shapes():
    """paper-lm-100m's parameter shapes (abstract: no weights made) and
    the port's stacked mask over them."""
    model = build_model(jax_config("paper-lm-100m"))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    leaves, _ = tree_flatten(tree)
    stacked = tree_flatten(lm.stacked_mask(tree))[0]
    assert stacked == jax.tree.leaves(model.stacked_mask(tree))
    return tree, [tuple(x.shape) for x in leaves], stacked


@pytest.mark.parametrize("value_bits", [32, 8])
def test_paper_lm_exchange_bytes(value_bits):
    """The exchange's static and effective bytes for paper-lm-100m, 9
    compressed leaves in 86 rows and 3 dense ones, at each gamma_t; and
    the default (non-adaptive) trainer's bytes unchanged."""
    tree, shapes, stacked = _lm_shapes()
    comp = Compressor(gamma=0.01, method="block_topk", max_gamma=0.1,
                      value_bits=value_bits)
    plan = bucket.build_bucket_plan(shapes, stacked, comp)
    lanes = [ln for ln in plan.leaves if not ln.dense]
    assert (len(lanes), sum(ln.L for ln in lanes), len(plan.dense_ids)) \
        == (9, 86, 3)
    static, eff_of = LM_BYTES[value_bits]
    for gt, want in eff_of.items():
        wire_b, eff = plan_wire_bytes(plan, comp, f32(gt))
        assert (float(wire_b), float(eff)) == (static, want), gt
    # JAX's shape-only function reads every ndim >= 2 leaf as stacked:
    # other totals, held twin to twin
    jc = JCompressor(gamma=0.01, method="block_topk", max_gamma=0.1,
                     value_bits=value_bits)
    for gt in eff_of:
        assert float(jcomp.tree_effective_wire_bytes(
            tree, jc, jnp.float32(gt))) == float(
                compression.tree_effective_wire_bytes(tree, comp, f32(gt)))
    for gm, bits, want in ((0.01, 32, 6_528_000), (0.01, 8, 3_302_744),
                           (0.1, 32, 65_879_040)):
        c = Compressor(gamma=gm, method="block_topk", value_bits=bits)
        w, e = plan_wire_bytes(bucket.build_bucket_plan(shapes, stacked, c),
                               c)
        assert float(w) == float(e) == want


@pytest.mark.parametrize("gamma", [0.01, 0.04, 0.10])
@pytest.mark.parametrize("arch", ["paper-lm-100m", "qwen1.5-4b",
                                  "rwkv6-1.6b"])
def test_collective_bytes_match_jax(arch, gamma):
    """benchmarks/collective_bytes.py's table for every ported config: the
    port's ``tree_wire_bytes`` over its own parameter tree (shapes only,
    under FakeTensorMode: no weights made) and the dense bytes equal the
    JAX package's over ``jax.eval_shape`` of its model."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    model = build_model(jax_config(arch))
    jtree = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,),
                                                            jnp.uint32))
    with FakeTensorMode():
        ttree = lm.init_params(get_config(arch))
    tleaves = tree_flatten(ttree)[0]
    assert [tuple(x.shape) for x in tleaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(jtree)]
    dense = sum(x.size * 4 for x in jax.tree.leaves(jtree))
    assert sum(x.numel() * 4 for x in tleaves) == dense
    wire = jcomp.tree_wire_bytes(jtree, JCompressor(gamma=gamma))
    assert compression.tree_wire_bytes(ttree, Compressor(gamma=gamma)) == \
        wire
    assert 0 < wire < dense


# ---------------------------------------------------------------------------
# single-node CSGD-ASSS under each schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["fixed", "linear", "armijo-coupled",
                                      "ef-coupled"])
def test_csgd_asss_schedules_match_jax(schedule):
    """Three CSGD-ASSS steps on the paper MLP (one hidden layer of 64)
    with block_topk at a 10% budget from gamma 1%; linear ramps over 2
    steps, theory_safe clamps the step scale."""
    jcfg_net = jpm.PaperNetConfig(name="t", kind="mlp", n_classes=10,
                                  widths=(64,))
    tcfg_net = pm.PaperNetConfig(name="t", kind="mlp", n_classes=10,
                                 widths=(64,))
    comp = dict(gamma=0.01, method="block_topk", max_gamma=0.1)
    ctrl = dict(schedule=schedule, ramp_steps=2)
    arm = dict(theory_safe=schedule == "linear")
    jopt = jcsgd_asss(JCSGDConfig(
        armijo=JArmijo(**arm), compressor=JCompressor(**comp),
        gamma_ctrl=jgamma.GammaControllerConfig(**ctrl)))
    topt = csgd_asss(CSGDConfig(
        armijo=ArmijoConfig(**arm), compressor=Compressor(**comp),
        gamma_ctrl=gamma.GammaControllerConfig(**ctrl)))
    jparams = jpm.init_net(jcfg_net, jax.random.PRNGKey(0))
    tparams = to_torch(jax.tree.map(np.asarray, jparams))
    js, ts = jopt.init(jparams), topt.init(tparams)

    @jax.jit
    def jstep(p, s, x, y):
        return jopt.step(lambda q: jpm.net_loss(jcfg_net, q,
                                                {"x": x, "y": y}), p, s)

    gammas = []
    for t in range(3):
        x, y = jsyn.teacher_classification(8, n_classes=10, seed=t)
        jparams, js, ja = jstep(jparams, js, x, y)
        tb = {"x": torch.from_numpy(np.asarray(x)),
              "y": torch.from_numpy(np.asarray(y))}
        tparams, ts, ta = topt.step(
            lambda q: pm.net_loss(tcfg_net, q, tb), tparams, ts)
        np.testing.assert_allclose(float(ta.loss), float(ja.loss),
                                   rtol=1e-5, err_msg=f"step {t}")
        assert float(ta.alpha) == float(ja.alpha), t
        assert int(ta.n_evals) == int(ja.n_evals), t
        for f in ("gamma", "eta", "wire_bytes", "eff_wire_bytes",
                  "cum_eff_bytes"):
            assert _bits(getattr(ta, f)) == _bits(getattr(ja, f)), (t, f)
        for jl, tl in zip(jparams, tparams):
            for k in jl:
                scale = float(jnp.max(jnp.abs(jl[k])))
                assert np.abs(np.asarray(jl[k]) - tl[k].numpy()).max() \
                    <= 1e-5 * scale, (t, k)
        gammas.append(float(ta.gamma))
    if schedule == "linear":
        np.testing.assert_allclose(gammas, [0.01, 0.055, 0.1], rtol=1e-6)
    if schedule != "fixed":
        assert float(ta.eff_wire_bytes) <= float(ta.wire_bytes)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def test_train_cli_perleaf_linear_on_cpu(tmp_path):
    """``--smoke --transport perleaf --max-gamma 0.1 --gamma-schedule
    linear``: gamma_t ramps 0.04 -> 0.07 -> 0.1 and each step's effective
    bytes are the exchange's figure at its gamma_t."""
    out = tmp_path / "log.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "3", "--seq-len", "33", "--global-batch",
         "4", "--compress-method", "block_topk", "--transport", "perleaf",
         "--max-gamma", "0.1", "--gamma", "0.04", "--gamma-schedule",
         "linear", "--gamma-ramp-steps", "2", "--value-bits", "8",
         "--log-every", "1", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    log = json.loads(out.read_text())
    # the ramp's f32 fused multiply-add ends an ulp under f32(0.1)
    np.testing.assert_allclose([m["gamma"] for m in log], [0.04, 0.07, 0.1],
                               rtol=1e-6)
    from repro_torch.configs import get_smoke_config
    params = lm.init_params(get_smoke_config("paper-lm-100m"))
    leaves, _ = tree_flatten(params)
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    plan = bucket.build_bucket_plan(
        [tuple(p.shape) for p in leaves], tree_flatten(
            lm.stacked_mask(params))[0], comp)
    cum = f32(0.0)
    for m in log:
        wire_b, eff = plan_wire_bytes(plan, comp, f32(m["gamma"]))
        cum = cum + eff
        assert (m["wire_bytes"], m["effective_wire_bytes"],
                m["cum_effective_wire_bytes"]) == \
            (float(wire_b), float(eff), float(cum))
        assert np.isfinite(m["loss"]) and not m["steps_skipped"]
    assert log[0]["effective_wire_bytes"] < log[-1]["effective_wire_bytes"] \
        == log[-1]["wire_bytes"]
