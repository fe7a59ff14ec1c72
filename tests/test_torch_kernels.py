"""The port's kernel ops against their JAX twins.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in
interpret mode, as the JAX package's own tests run it on the CPU) and
``repro_torch.kernels.ops`` (the plain PyTorch versions on the CPU).

Tolerances: tau (NaN where the TPU kernel gives NaN), sent, m', the
dense splits, packed words and unpacked fields are bit-exact.  The
per-row moments [sum g^2, sum acc^2] are f32 sums whose reduction order
differs between XLA and PyTorch; DESIGN.md §11 holds them to 8 ulp.

The serving kernels' plain versions (RMSNorm, attention, the RWKV-6 WKV
recurrence) go against the JAX package's: RMSNorm against its Pallas
kernel in interpret mode, attention and WKV against its jnp oracles
(its Pallas flash-attention and WKV kernels do not run on this JAX;
ROADMAP queue 3).  f32: atol 1e-5 (RMSNorm, attention; JAX's own RMSNorm
bound) and 2e-5 (WKV); bf16: at most 1 bf16 ulp.

tests/test_torch_gpu.py holds each CUDA kernel against its plain version
on the card.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ef_topk as jef_topk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels import ef_topk, wire_pack
from test_torch_gpu import ef_inputs, pass1_rows, selection_rows

torch.set_num_threads(2)

INTERP = "pallas-interpret"


def _leaves(seed, shapes, ties=False):
    rng = np.random.default_rng(seed)
    ms, gs = [], []
    for s in shapes:
        m = rng.standard_normal(s).astype(np.float32) * 0.05
        g = rng.standard_normal(s).astype(np.float32)
        if ties:
            # duplicated magnitudes (rounded values, both signs) and whole
            # zero blocks: exactly the cases where the selection's tie
            # order decides which element is knocked out
            g = np.round(g * 2.0).astype(np.float32)
            m = np.zeros_like(m)
            g.reshape(-1)[:1024] = 0.0
        ms.append(m)
        gs.append(g)
    return ms, gs


def _u32(t):
    return np.asarray(t.numpy()).view(np.uint32)


@pytest.mark.parametrize("gamma,ties", [(0.01, False), (0.05, False),
                                        (0.01, True)])
def test_fused_ef_compress_batched_matches_jax(gamma, ties):
    shapes = [(3, 2048), (2, 1500), (5000,)]      # ragged multi-leaf list
    ms, gs = _leaves(7, shapes, ties)
    eta = np.float32(0.37)
    want = jops.fused_ef_compress_batched(
        [jnp.asarray(m) for m in ms], [jnp.asarray(g) for g in gs],
        jnp.float32(eta), gamma, telemetry=True, impl=INTERP)
    got = ops.fused_ef_compress_batched(
        [torch.from_numpy(m) for m in ms], [torch.from_numpy(g) for g in gs],
        torch.tensor([eta]), gamma)
    for (js, jm, jt, jmom), (ts, tm, tt, tmom), m, g in zip(want, got, ms,
                                                            gs):
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_max_ulp(np.asarray(jmom), tmom.numpy(),
                                        maxulp=8)
        # the EF identity against the single-rounding accumulator
        acc = ref.ef_acc(torch.from_numpy(m), torch.from_numpy(g),
                         torch.tensor([eta])).reshape(m.shape)
        np.testing.assert_array_equal((ts + tm).numpy(), acc.numpy())


def _special_rows():
    """Block rows that decide the selection's edge cases: one NaN,
    several NaNs, +inf twice, -inf, all zeros, rounded ties, all equal."""
    x = np.random.default_rng(21).standard_normal((8, 1024)).astype(
        np.float32)
    x[1, 5] = np.nan
    x[2, [3, 700, 900]] = np.nan
    x[3, [10, 600]] = np.inf
    x[4, 11] = -np.inf
    x[5] = 0.0
    x[6] = np.round(x[6] * 2.0)
    x[7] = -1.5
    return x


@pytest.mark.parametrize("k_b", [1, 10, 1024])
def test_selection_plain_versions_follow_the_kernels_nan_rule(k_b):
    """A row holding a NaN gets tau = NaN from the TPU kernels (their
    per-round max propagates NaN, then knocks nothing out); the plain
    versions give the same, and equal taus everywhere else.  Moments:
    8 ulp on finite rows, the same NaN/inf elsewhere."""
    x = _special_rows()
    m = np.random.default_rng(22).standard_normal(x.shape).astype(
        np.float32) * 0.05
    eta = np.float32(0.37)
    jx, jm, jeta = jnp.asarray(x), jnp.asarray(m), jnp.float32(eta)
    tx, tm, teta = torch.from_numpy(x), torch.from_numpy(m), \
        torch.tensor([eta])
    jtau = np.asarray(jef_topk.block_stats(jx, k_b, interpret=True))
    ttau = ref.block_abs_topk_threshold(tx, k_b).numpy()
    assert np.isnan(jtau[1:3]).all()
    np.testing.assert_array_equal(jtau, ttau)
    np.testing.assert_array_equal(
        np.asarray(jef_topk.ef_block_stats(jm, jx, jeta, k_b,
                                           interpret=True)),
        ref.ef_block_stats(tm, tx, teta, k_b).numpy())
    jt2, jmom = jef_topk.ef_stats_telemetry(jm, jx, jeta, k_b,
                                            interpret=True)
    tt2, tmom = ref.ef_block_stats_telemetry(tm, tx, teta, k_b)
    np.testing.assert_array_equal(np.asarray(jt2), tt2.numpy())
    jmom, tmom = np.asarray(jmom), tmom.numpy()
    fin = np.isfinite(jmom).all(1)
    np.testing.assert_array_max_ulp(jmom[fin], tmom[fin], maxulp=8)
    np.testing.assert_array_equal(jmom[~fin], tmom[~fin])
    js, jr = jef_topk.threshold_split(jx, jnp.asarray(jtau), interpret=True)
    ts, tr = ref.threshold_split(tx, torch.from_numpy(ttau))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


# The pass-1 kernels' select in csrc/ef_topk.cu (select_kth), emulated on
# the sign-cleared uint32 patterns of a row in the kernels' lane layout:
# slot s of lane l holds column ((s >> 2) * 32 + l) * 4 + (s & 3).
_SLOT = np.arange(32)
_LANE_COLS = ((_SLOT[None, :] >> 2) * 32 + np.arange(32)[:, None]) * 4 \
    + (_SLOT[None, :] & 3)                       # (lane, slot) -> column
_CAP = 256                                       # the kernel's kCap


def _kth_by_bits(v, k, lo, hi, stop=0):
    """kth_by_bits: the largest t, a multiple of 2^stop, with
    #{v >= t} >= k, its bits set from the highest one where lo and hi
    differ, one warp count a bit."""
    if lo == hi:
        return lo
    top = (lo ^ hi).bit_length() - 1
    t = lo & ~((2 << top) - 1)
    for b in range(top, stop - 1, -1):
        if np.count_nonzero(v >= (t | 1 << b)) >= k:
            t |= 1 << b
    return t


def _emulate_select(patterns, k_b):
    """(tau (R, 1) f32, the path of each row: 'nan', 'filter' or
    'general') as select_kth computes them from (R, 1024) sign-cleared
    patterns."""
    taus, paths = [], []
    for u in patterns:
        hi = int(u.max())
        if hi > 0x7f800000:                      # a NaN in the row
            taus.append(np.float32(np.nan))
            paths.append("nan")
            continue
        lo, t, path = 0, None, "general"
        if k_b <= 128:
            # the filter's bound: the k_b-th largest of the maxima of each
            # lane's J groups of 32 / J slots, cut to its top 16 bits
            J = 1 if k_b <= 32 else 4 if k_b <= 64 else 8
            gmax = u[_LANE_COLS].reshape(32, J, 32 // J).max(axis=2)
            lo = _kth_by_bits(gmax, k_b, int(gmax.min()), hi, stop=16)
            cand = u[u >= lo]
            assert cand.size >= k_b                # lo bounds tau below
            if cand.size <= _CAP:
                path = "filter"
                if cand.size <= 32:                # the rank pick
                    gt = (cand[None, :] > cand[:, None]).sum(1)
                    ge = (cand[None, :] >= cand[:, None]).sum(1)
                    t = int(cand[(gt < k_b) & (k_b <= ge)][0])
                else:
                    t = _kth_by_bits(cand, k_b, lo, hi)
        if t is None:
            t = _kth_by_bits(u, k_b, lo, hi)
        taus.append(np.uint32(t).view(np.float32))
        paths.append(path)
    return np.array(taus, np.float32).reshape(-1, 1), paths


def _emulate_block_stats(x, k_b):
    """block_stats_kernel: the select on the patterns of |x|."""
    return _emulate_select(x.view(np.uint32) & np.uint32(0x7fffffff), k_b)


def _emulate_pass1(m, g, eta, k_b):
    """(tau, moments, paths) as the EF pass-1 kernels compute them: acc =
    fma(eta, g, m) rounded once (ref.ef_acc), the select on the patterns of
    |acc|, and the moments [sum g^2, sum acc^2] summed in f64 as a lane
    does (its 32 slots in load order; each f32 square is exact in f64, so
    a sum and an fma agree), then the warp's xor-shuffle sum, rounded to
    f32 once."""
    acc = ref.ef_acc(torch.from_numpy(m), torch.from_numpy(g),
                     torch.tensor([eta])).numpy()
    tau, paths = _emulate_select(acc.view(np.uint32)
                                 & np.uint32(0x7fffffff), k_b)
    moments = []
    for v in (g, acc):
        sq = v.astype(np.float64)[:, _LANE_COLS] ** 2      # (R, lane, slot)
        lane = np.zeros(sq.shape[:2])
        for s in range(32):
            lane = lane + sq[:, :, s]
        for off in (16, 8, 4, 2, 1):
            lane = lane + lane[:, np.arange(32) ^ off]
        with np.errstate(over="ignore"):       # inf, as the kernel rounds
            moments.append(lane[:, 0].astype(np.float32))
    return tau, np.stack(moments, axis=1), paths


def _flushed(a):
    """a with its subnormal values flushed to zero of their sign, as XLA
    on the CPU treats subnormal inputs and results."""
    return np.where(np.abs(a) < np.float32(2.0**-126),
                    np.copysign(np.float32(0.0), a), a).astype(np.float32)


def _assert_moments(got, want):
    """8 ulp where a moment is finite, equal (NaN as NaN) elsewhere."""
    fin = np.isfinite(want)
    np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=8)
    np.testing.assert_array_equal(got[~fin], want[~fin])


def _assert_same_bits(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("k_b", [1, 10, 31, 32, 33, 41, 102, 1023, 1024])
def test_block_stats_select_emulation_matches_jax(k_b):
    """The select of block_stats_kernel, emulated in its lane layout, is
    bit-exact against the plain version and JAX's Pallas kernel in
    interpret mode on rows that reach each of its paths, and each row
    takes the path its kind predicts."""
    kinds, x = selection_rows(k_b)
    tau, paths = _emulate_block_stats(x, k_b)
    _assert_same_bits(tau, ref.block_abs_topk_threshold(
        torch.from_numpy(x), k_b).numpy())
    # XLA on the CPU flushes subnormals in the Pallas kernel's max
    # reduction (tau 0 for a subnormal row); JAX's jnp oracle keeps them,
    # as the port does (ROADMAP queue 3)
    sub = np.array([k == "subnormal" for k in kinds])
    _assert_same_bits(tau[~sub], np.asarray(jef_topk.block_stats(
        jnp.asarray(x[~sub]), k_b, interpret=True)))
    _assert_same_bits(tau[sub], np.asarray(jref.block_abs_topk_threshold(
        jnp.asarray(x[sub]).reshape(-1), k_b, 1024)).reshape(-1, 1))
    filtered = "filter" if k_b <= 128 else "general"
    want = {"gauss": filtered, "subnormal": filtered, "equal": "general",
            "zeros": "general", "signed_zeros": "general",
            "ties_under_cap": filtered, "ties_over_cap": "general",
            "nan": "nan", "nan_inf": "nan"}
    assert {k: p for k, p in zip(kinds, paths) if k in want} == want


@settings(max_examples=60, deadline=None, database=None)
@given(k_b=st.integers(1, 1024), seed=st.integers(0, 2**32 - 1),
       distinct=st.sampled_from([1, 2, 5, 40, 300, 1024]),
       special=st.sampled_from([0.0, np.inf, 1e-40, 1e30]),
       n_special=st.integers(0, 1024))
def test_block_stats_select_emulation_property(k_b, seed, distinct, special,
                                               n_special):
    """The emulated select against the plain version on rows drawn from a
    pool of a few distinct magnitudes (ties), with zeros, infinities,
    subnormals or large values mixed in."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(distinct).astype(np.float32)
    x = rng.choice(pool, 1024) * np.where(rng.random(1024) < 0.5, 1, -1)
    x[rng.choice(1024, n_special, replace=False)] = special
    x = x.astype(np.float32).reshape(1, 1024)
    tau, _ = _emulate_block_stats(x, k_b)
    _assert_same_bits(tau, ref.block_abs_topk_threshold(
        torch.from_numpy(x), k_b).numpy())


@pytest.mark.parametrize("k_b", [1, 10, 31, 32, 33, 41, 102, 1023, 1024])
def test_ef_pass1_select_emulation_matches_jax(k_b):
    """The EF pass-1 kernels emulated in their lane layout (the select of
    block_stats on the patterns of |fma(eta, g, m)|, the moments in the
    kernels' order) on accumulators that reach each path of the select,
    ties, zeros and subnormals made by cancellation: tau bit-exact against
    the plain version and JAX's ef_stats_telemetry and ef_block_stats in
    interpret mode, the moments within 8 ulp of both, and each row on the
    path its kind predicts.  XLA on the CPU flushes subnormal inputs and
    results, so on the subnormal row JAX (its jnp oracle and its Pallas
    kernel alike) selects among the accumulators eta*g + m formed from
    flushed operands and flushed again, while the port keeps them, as
    the card does (ROADMAP queue 3)."""
    kinds, m, g = pass1_rows(k_b)
    eta = np.float32(0.0345)
    tau, moments, paths = _emulate_pass1(m, g, eta, k_b)
    tm, tg, teta = torch.from_numpy(m), torch.from_numpy(g), \
        torch.tensor([eta])
    rtau, rmom = ref.ef_block_stats_telemetry(tm, tg, teta, k_b)
    _assert_same_bits(tau, rtau.numpy())
    _assert_same_bits(tau, ref.ef_block_stats(tm, tg, teta, k_b).numpy())
    _assert_moments(moments, rmom.numpy())

    sub = np.array([k == "subnormal" for k in kinds])
    jm, jg, jeta = jnp.asarray(m), jnp.asarray(g), jnp.float32(eta)
    jtau, jmom = jef_topk.ef_stats_telemetry(jm, jg, jeta, k_b,
                                             interpret=True)
    jtau2 = jef_topk.ef_block_stats(jm, jg, jeta, k_b, interpret=True)
    _assert_same_bits(tau[~sub], np.asarray(jtau)[~sub])
    _assert_same_bits(tau[~sub], np.asarray(jtau2)[~sub])
    _assert_moments(moments, np.asarray(jmom))
    # the subnormal row: JAX's oracle and kernel select among the flushed
    # accumulators; the port's tau is a subnormal value of the unflushed
    acc_xla = _flushed(_flushed(m[sub]) + _flushed(eta * _flushed(g[sub])))
    want_xla, _ = _emulate_select(acc_xla.view(np.uint32)
                                  & np.uint32(0x7fffffff), k_b)
    oracle, _ = jref.ef_block_stats_telemetry(jnp.asarray(m[sub]),
                                              jnp.asarray(g[sub]), jeta, k_b)
    _assert_same_bits(want_xla, np.asarray(oracle))
    _assert_same_bits(want_xla, np.asarray(jtau)[sub])
    assert 0 < tau[sub][0, 0] < 2.0**-126

    filtered = "filter" if k_b <= 128 else "general"
    want = {"gauss": filtered, "subnormal": filtered, "equal": "general",
            "zeros": "general", "signed_zeros": "general",
            "ties_under_cap": filtered, "ties_over_cap": "general",
            "nan": "nan", "nan_inf": "nan", "inf_minus_inf": "nan",
            "trainer": filtered}
    assert {k: p for k, p in zip(kinds, paths) if k in want} == want


@settings(max_examples=40, deadline=None, database=None)
@given(k_b=st.integers(1, 1024), seed=st.integers(0, 2**32 - 1),
       distinct=st.sampled_from([1, 2, 5, 40, 300, 1024]),
       special=st.sampled_from([0.0, np.inf, 1e-40, 1e30]),
       n_special=st.integers(0, 1024), n_rounded=st.integers(0, 1024))
def test_ef_pass1_select_emulation_property(k_b, seed, distinct, special,
                                            n_special, n_rounded):
    """The emulated EF pass-1 select against the plain version on
    accumulators drawn as in the block_stats property (a pool of a few
    magnitudes, zeros, infinities, subnormals or large values mixed in),
    formed exactly by cancellation, with n_rounded of them moved off it:
    m scaled by 1 + 2^-10, which the fma then rounds."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(distinct).astype(np.float32)
    x = rng.choice(pool, 1024) * np.where(rng.random(1024) < 0.5, 1, -1)
    x[rng.choice(1024, n_special, replace=False)] = special
    x = x.astype(np.float32).reshape(1, 1024)
    eta = np.float32(0.0345)
    m, g = ef_inputs(x, eta, seed)
    moved = rng.choice(1024, n_rounded, replace=False)
    m[0, moved] *= np.float32(1 + 2.0**-10)
    tau, _, _ = _emulate_pass1(m, g, eta, k_b)
    _assert_same_bits(tau, ref.ef_block_stats_telemetry(
        torch.from_numpy(m), torch.from_numpy(g), torch.tensor([eta]),
        k_b)[0].numpy())


@pytest.mark.parametrize("shape", [(5000,), (3, 2048), (2, 1500)])
@pytest.mark.parametrize("k_b", [1, 10, 51])
def test_dense_selection_ops_match_jax(shape, k_b):
    """block_topk_threshold, threshold_split_blocks and fused_ef_compress
    (with and without moments) against the JAX ops, on padded tails and a
    zero block."""
    rng = np.random.default_rng(k_b)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:1024] = 0.0
    m = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    eta = np.float32(0.37)
    jx, jm, tx, tm = jnp.asarray(x), jnp.asarray(m), torch.from_numpy(x), \
        torch.from_numpy(m)
    jtau = jops.block_topk_threshold(jx, k_b, impl=INTERP)
    ttau = ops.block_topk_threshold(tx, k_b)
    np.testing.assert_array_equal(np.asarray(jtau), ttau.numpy())
    js, jr = jops.threshold_split_blocks(jx.reshape(-1), jtau.reshape(-1, 1),
                                         impl=INTERP)
    ts, tr = ops.threshold_split_blocks(tx.reshape(-1), ttau.reshape(-1, 1))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal((ts + tr).numpy(), x.reshape(-1))
    gamma = k_b / 1024
    for tel in (False, True):
        want = jops.fused_ef_compress(jm, jx, eta, gamma, telemetry=tel,
                                      impl=INTERP)
        got = ops.fused_ef_compress(tm, tx, eta, gamma, telemetry=tel)
        assert len(got) == len(want) == 3 + tel
        for j, t in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        if tel:
            np.testing.assert_array_max_ulp(np.asarray(want[3]),
                                            got[3].numpy(), maxulp=8)


def test_acc_rounds_once_like_jax():
    """addcmul forms m + eta*g with one rounding, as the JAX kernel does;
    the two-rounding expression differs (the hazard the kernels avoid)."""
    ms, gs = _leaves(3, [(64, 1024)])
    eta = np.float32(0.37)
    _, jm = jops.ef_apply(jnp.asarray(ms[0]), jnp.asarray(gs[0]),
                          jnp.float32(eta).reshape(1),
                          jnp.full((64, 1), jnp.inf), interpret=True)
    acc = ref.ef_acc(torch.from_numpy(ms[0]), torch.from_numpy(gs[0]),
                     torch.tensor([eta]))
    np.testing.assert_array_equal(np.asarray(jm), acc.numpy())
    two = torch.from_numpy(ms[0]) + torch.tensor(eta) * torch.from_numpy(
        gs[0])
    assert (two != acc).any()


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("ragged", [False, True])
def test_pack_unpack_fields_match_jax(bits, ragged):
    rng = np.random.default_rng(bits)
    R, n = 6, 77
    fields = rng.integers(0, 2**32, (R, n), dtype=np.uint64).astype(
        np.uint32)
    counts = rng.integers(0, 12, R).astype(np.int32) if ragged else None
    period = 11 if ragged else 0
    kw = dict(counts=None if counts is None else jnp.asarray(counts),
              period=period)
    jw = jops.pack_fields(jnp.asarray(fields), bits, impl=INTERP, **kw)
    tkw = dict(counts=None if counts is None else torch.from_numpy(counts),
               period=period)
    tw = ops.pack_fields(torch.from_numpy(fields.view(np.int32)), bits,
                         **tkw)
    np.testing.assert_array_equal(np.asarray(jw), _u32(tw))
    jf = jops.unpack_fields(jw, n, bits, impl=INTERP, **kw)
    tf = ops.unpack_fields(tw, n, bits, **tkw)
    np.testing.assert_array_equal(np.asarray(jf), _u32(tf))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_pack_unpack_stream_match_jax(bits):
    rng = np.random.default_rng(100 + bits)
    F = max(1, 32 // bits)
    n = F * 1300                                  # > WORD_CHUNK words
    fields = rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32)
    jw = jops.pack_fields_stream(jnp.asarray(fields), bits, impl=INTERP)
    tw = ops.pack_fields_stream(torch.from_numpy(fields.view(np.int32)),
                                bits)
    np.testing.assert_array_equal(np.asarray(jw), _u32(tw))
    jf = jops.unpack_fields_stream(jw, bits, impl=INTERP)
    tf = ops.unpack_fields_stream(tw, bits)
    np.testing.assert_array_equal(np.asarray(jf), _u32(tf))
    np.testing.assert_array_equal(_u32(tf), fields)


def test_stream_shape_matches_jax():
    from repro.kernels import wire_pack as jwp
    for n in (0, 1, 511, 512, 513, 537_000):
        assert wire_pack.stream_shape(n) == jwp.stream_shape(n)


def _vector_head(in_addr, in_bytes, out_addr, out_bytes):
    """``csrc/wire_pack.cu`` ``vector_head``: the first word (0..3) at
    which both pointers are 16-byte aligned, -1 if none."""
    for h in range(4):
        if (in_addr + h * in_bytes) % 16 == 0 \
                and (out_addr + h * out_bytes) % 16 == 0:
            return h
    return -1


def _emulate_wire(x, bits, pack, in_addr, out_addr):
    """``csrc/wire_pack.cu``'s launcher and its kVector and kScalar paths
    over a flat stream, in their lane layout: x the uint32 fields (pack)
    or words (unpack), in_addr and out_addr the two pointers' offsets
    from a 16-byte boundary.  Each warp takes a tile of 128 words; lane l
    moves field vector q * 32 + l of it (4 fields); the head and tail
    words go one a thread to the first threads of the grid."""
    F, mask = 32 // bits, (1 << bits) - 1
    n = x.size // F if pack else x.size
    out = np.full(n if pack else n * F, 0xA5A5A5A5, np.uint32)

    def pack_word(v):                       # (..., F) fields -> words
        return np.bitwise_or.reduce(
            [(v[..., f] & mask) << (f * bits) for f in range(F)])

    def scalar(i):
        if pack:
            out[i] = pack_word(x[i * F:(i + 1) * F])
        else:
            out[i * F:(i + 1) * F] = [(x[i] >> (f * bits)) & mask
                                      for f in range(F)]

    head = _vector_head(in_addr, 4 * F if pack else 4, out_addr,
                        4 if pack else 4 * F)
    if head < 0 or head > n:                # kScalar: one word a thread
        for i in range(n):
            scalar(i)
        return out
    tiles, lane = (n - head) >> 7, np.arange(32)
    words = (out if pack else x)[head:head + tiles * 128].reshape(tiles, 128)
    fields = (x if pack else out)[head * F:(head + tiles * 128) * F].reshape(
        tiles, 32 * F, 4)
    for q in range(F):
        if pack:
            a = fields[:, q * 32 + lane].astype(np.int64)
            if F == 2:     # vector j: the fields of words 2j, 2j + 1
                words.reshape(tiles, 64, 2)[:, q * 32 + lane] = np.stack(
                    [pack_word(a[..., :2]), pack_word(a[..., 2:])], -1)
            elif F == 4:   # vector j: word j
                words[:, q * 32 + lane] = pack_word(a)
            else:          # vector j: half j % 2 of word j / 2, one shuffle
                part = pack_word(np.pad(a, [(0, 0), (0, 0), (0, 4)])) \
                    << ((lane & 1) * 16)
                part |= part[:, lane ^ 1]
                even = lane[::2]
                words[:, q * 16 + even // 2] = part[:, even]
        else:
            if F == 2:
                w = words.reshape(tiles, 64, 2)[:, q * 32 + lane]
                w = w.astype(np.int64)
                a = np.stack([w[..., 0] & mask, w[..., 0] >> 16,
                              w[..., 1] & mask, w[..., 1] >> 16], -1)
            elif F == 4:
                w = words[:, q * 32 + lane].astype(np.int64)
                a = np.stack([(w >> s) & mask for s in (0, 8, 16, 24)], -1)
            else:
                w = words[:, q * 16 + lane // 2].astype(np.int64) \
                    >> ((lane & 1) * 16)
                a = np.stack([(w >> s) & mask for s in (0, 4, 8, 12)], -1)
            fields[:, q * 32 + lane] = a
    tail = (n - head) & 127
    for t in range(head + tail):            # the edge words
        scalar(t if t < head else n - tail + (t - head))
    return out


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("in_addr", [0, 4, 8, 12])
def test_wire_vector_layout_emulation_matches_plain(bits, pack, in_addr):
    """The CUDA kernels' tile and lane layout, emulated, gives the plain
    version's words and fields at every alignment of the two pointers and
    at stream lengths around a warp's 128-word tile."""
    F = 32 // bits
    rng = np.random.default_rng(bits * 100 + in_addr)
    for out_addr in (0, 4, 8, 12):
        for n in (1, 3, 127, 128, 131, 300, 1015):
            x = rng.integers(0, 2**32, n * F if pack else n,
                             dtype=np.uint64).astype(np.uint32)
            got = _emulate_wire(x, bits, pack, in_addr, out_addr)
            t = torch.from_numpy(x.view(np.int32)).reshape(1, -1)
            want = ref.pack_fields(t, bits) if pack else \
                ref.unpack_fields(t, bits)
            np.testing.assert_array_equal(got, _u32(want.reshape(-1)))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("period", [11, 29])
def test_wire_ragged_running_counter_matches_plain(bits, period):
    """The ragged kernels' field mask: j % period once a word (32-bit),
    then a counter that wraps at the period across the word's fields."""
    F = 32 // bits
    rng = np.random.default_rng(period + bits)
    rows, cols = 7, 45
    counts = rng.integers(-1, period + 2, rows).astype(np.int32)
    valid = np.zeros((rows, cols * F), bool)
    for r in range(rows):
        for w in range(cols):
            p = (w * F) % period
            for f in range(F):
                valid[r, w * F + f] = p < counts[r]
                p = 0 if p + 1 == period else p + 1
    x = torch.from_numpy(rng.integers(0, 2**32, (rows, cols * F),
                                      dtype=np.uint64).astype(
        np.uint32).view(np.int32))
    c = torch.from_numpy(counts)
    masked = torch.where(torch.from_numpy(valid), x, 0)
    assert torch.equal(ref.pack_fields(x, bits, c, period),
                       ref.pack_fields(masked, bits))
    words = ref.pack_fields(x, bits)
    assert torch.equal(ref.unpack_fields(words, bits, c, period),
                       torch.where(torch.from_numpy(valid),
                                   ref.unpack_fields(words, bits), 0))


def test_dispatch_follows_device():
    reg = dispatch.registered()
    for op in ("ef_stats_telemetry", "ef_stats", "block_stats",
               "ef_update", "threshold_split", "wire_pack", "wire_unpack"):
        assert reg[op] == ("ref", "cuda")
    assert dispatch.resolve(torch.zeros(1)) == "ref"
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.resolve(torch.zeros(1, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper checks its inputs before it builds or launches, and
    never runs the plain version itself."""
    m = torch.zeros(2, 1024)
    eta = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        ef_topk.ef_stats_telemetry(m, m, eta, 10)
    with pytest.raises(ValueError, match="CUDA"):
        ef_topk.ef_block_stats(m, m, eta, 10)
    with pytest.raises(ValueError, match="CUDA"):
        ef_topk.block_stats(m, 10)
    with pytest.raises(ValueError, match="CUDA"):
        ef_topk.ef_apply(m, m, eta, torch.zeros(2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        ef_topk.threshold_split(m, torch.zeros(2, 1))
    w = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wire_pack.pack_words(w, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wire_pack.unpack_words(w, 8)
    assert all(v == 0 for v in ops.launch_counts().values())


# --------------------------------------------------------------------------
# serving: RMSNorm, attention, WKV
# --------------------------------------------------------------------------

def _bf16_bits(a) -> np.ndarray:
    """int32 bit patterns of a bf16 array (JAX) or tensor (torch)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def _assert_bf16_within_1ulp(jax_out, torch_out):
    assert torch_out.dtype == torch.bfloat16
    diff = np.abs(_bf16_bits(jax_out) - _bf16_bits(torch_out))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("shape", [(8, 128), (2, 100, 256), (3, 7, 512)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_pallas_interpret(shape, xdt, wdt):
    rng = np.random.default_rng(len(shape) * shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, jw = jnp.asarray(x, xdt), jnp.asarray(w, wdt)
    want = jops.rms_norm(jx, jw, eps=1e-6, impl=INTERP)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    got = ref.rmsnorm_reference(tx, tw, 1e-6)
    assert torch.equal(ops.rms_norm(tx, tw, eps=1e-6), got)   # CPU: plain
    if xdt == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    else:
        _assert_bf16_within_1ulp(want, got)


def _qkv(seed, shape_q, shape_k, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape_q) * 0.1).astype(np.float32)
    k = (rng.standard_normal(shape_k) * 0.1).astype(np.float32)
    v = rng.standard_normal(shape_k).astype(np.float32)
    return ([jnp.asarray(t, dtype) for t in (q, k, v)],
            [torch.from_numpy(t).to(getattr(torch, dtype))
             for t in (q, k, v)])


@pytest.mark.parametrize("shape", [(1, 2, 128, 32), (2, 4, 256, 64),
                                   (1, 8, 512, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 64])
def test_attention_plain_matches_jax_oracle(shape, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape[2], shape, shape)
    want = jref.mha_reference(jq, jk, jv, causal=causal, window=window)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("q_offset", [None, 64])
def test_attention_plain_rectangular_and_offset_match_jax(q_offset):
    """Sq < Sk: queries at the trailing positions, or at an explicit
    offset (a query chunk of the CPU prefill)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, (2, 2, 128, 64), (2, 2, 256, 64))
    want = jref.mha_reference(jq, jk, jv, causal=True, q_offset=q_offset)
    got = ref.mha_reference(tq, tk, tv, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_attention_plain_bf16_matches_jax_oracle():
    shape = (1, 2, 256, 64)
    (jq, jk, jv), (tq, tk, tv) = _qkv(6, shape, shape, "bfloat16")
    want = jref.mha_reference(jq, jk, jv)
    got = ops.attention(tq, tk, tv)
    _assert_bf16_within_1ulp(want, got)


def _emulate_tensor_core_flash(q, k, v, causal, split_p, tile=64):
    """The bf16 tensor-core kernel's rounding in plain torch: f32 logits
    of the bf16 products, scaled after the product (times log2 e, for
    exp2), an online softmax over 64-key tiles, P rounded to bf16 once
    (P_hi) or as P_hi + P_lo, f32 accumulation, o = acc / l in bf16."""
    D, Sq, Sk = q.shape[-1], q.shape[2], k.shape[2]
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        D ** -0.5 * 1.4426950408889634)
    if causal:
        qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
        s_all = torch.where(torch.arange(Sk)[None] <= qpos, s_all,
                            torch.tensor(-1e30))
    m = torch.full(s_all.shape[:-1], -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s_all.shape[:-1], D)
    for t0 in range(0, Sk, tile):
        s, vt = s_all[..., t0:t0 + tile], v[:, :, t0:t0 + tile].float()
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + p_hi @ vt
        if split_p:
            acc = acc + (p - p_hi).bfloat16().float() @ vt
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).bfloat16()


def _bf16_ulp_err(got, want, atol):
    """Largest |got - want| in bf16 ulps of |want|, once atol is taken
    off (the check chip_smoke.py and test_torch_gpu.py apply)."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp(min=atol)).exponent - 8)
    return float(((got.float() - w).abs() - atol).clamp(min=0).div(ulp)
                 .max())


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_rounding_holds_the_bf16_flash_check(causal):
    """Why the bf16 flash kernel splits P: with P = P_hi + P_lo its
    rounding stays within 1 bf16 ulp + 1e-5 of the plain version at
    (1, 2, 512, 512, 128); rounding P once is reported, not asserted
    (thousands of ulps for outputs near zero)."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 512, 128))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    want = ref.mha_reference(q, k, v, causal=causal)
    split = _bf16_ulp_err(_emulate_tensor_core_flash(q, k, v, causal, True),
                          want, 1e-5)
    once = _bf16_ulp_err(_emulate_tensor_core_flash(q, k, v, causal, False),
                         want, 1e-5)
    print(f"causal={causal}: P split {split:.3f} bf16 ulp, P rounded once "
          f"{once:.1f} bf16 ulp (beyond 1e-5)")
    assert split <= 1


@pytest.mark.parametrize("S", [1, 8, 33])
@pytest.mark.parametrize("K", [8, 64])
def test_wkv_plain_matches_jax_oracle(S, K):
    B, H = 2, 2
    rng = np.random.default_rng(S * 100 + K)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(B, S, H, K) * 0.3, f(B, S, H, K) * 0.3, f(B, S, H, K)
    w = (1.0 / (1.0 + np.exp(-f(B, S, H, K)))).astype(np.float32)
    u, s0 = f(H, K) * 0.1, f(B, H, K, K) * 0.1
    args = (r, k, v, w, u, s0)
    jy, jsT = jax.jit(jref.wkv_reference)(*map(jnp.asarray, args))
    ty, tsT = ops.wkv(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tsT.numpy(), np.asarray(jsT), rtol=0,
                               atol=2e-5)


def _shipped_wkv_rows() -> int:
    """The state rows a thread owns in csrc/rwkv_wkv.cu as it ships."""
    src = (Path(ref.__file__).parents[1] / "csrc" / "rwkv_wkv.cu").read_text()
    return int(re.search(r"constexpr int kRows = (\d+);", src).group(1))


def _emulate_wkv_kernel(r, k, v, w, u, s0, rows):
    """The WKV kernel's order of operations in plain torch: K split into
    16-byte chunks over K / rows lanes, lane p owning chunks p, p +
    lanes, ...; per step kv = k v in f32, each multiply-add fused (f64,
    rounded once to f32), the lane's four partial sums of y (one per row
    of a chunk) added pairwise, then the lanes' sums added as the
    shuffles do: lanes p and p + lanes / 2 first, down to neighbours."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    B, S, H, K = r.shape
    V = v.shape[3]
    lanes = K // rows
    split = lambda x: x.reshape(*x.shape[:-1], rows // 4, lanes, 4)  # noqa
    st = split(s0.transpose(2, 3)).movedim(-3, -1)     # (B, H, V, l, 4, i)
    uu = split(u)[None, :, None].movedim(-3, -1)       # (1, H, 1, l, 4, i)
    ys = []
    for t in range(S):
        rt, kt, wt = (split(x[:, t])[:, :, None].movedim(-3, -1)
                      for x in (r, k, w))              # (B, H, 1, l, 4, i)
        kv = kt * v[:, t, :, :, None, None, None]
        tmp = fma(uu, kv, st)
        part = torch.zeros(st.shape[:-1])
        for i in range(rows // 4):
            part = fma(rt[..., i], tmp[..., i], part)
        x = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
        while x.shape[-1] > 1:
            half = x.shape[-1] // 2
            x = x[..., :half] + x[..., half:]
        ys.append(x[..., 0])
        st = fma(wt, st, kv)
    sT = st.movedim(-1, -3).reshape(B, H, V, K).transpose(2, 3)
    return torch.stack(ys, dim=1), sT


@pytest.mark.parametrize("shape", [(1, 1024, 2, 64), (2, 70, 3, 32)])
@pytest.mark.parametrize("which", ["shipped", "other"])
def test_wkv_kernel_order_holds_the_check(shape, which):
    """The order in which the CUDA WKV kernel sums (row slices per lane,
    fused multiply-adds, a shuffle tree for y) stays within atol 2e-5 of
    both plain versions, torch's and JAX's, at S = 1024 too: for the
    rows per thread the kernel ships with and for one other choice."""
    shipped = _shipped_wkv_rows()
    rows = shipped if which == "shipped" else (16 if shipped != 16 else 8)
    B, S, H, K = shape
    rng = np.random.default_rng(S * 100 + K)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(B, S, H, K) * 0.3, f(B, S, H, K) * 0.3, f(B, S, H, K)
    w = (1.0 / (1.0 + np.exp(-f(B, S, H, K)))).astype(np.float32)
    u, s0 = f(H, K) * 0.1, f(B, H, K, K) * 0.1
    args = (r, k, v, w, u, s0)
    ey, esT = _emulate_wkv_kernel(*map(torch.from_numpy, args), rows)
    ty, tsT = ref.wkv_reference(*map(torch.from_numpy, args))
    jy, jsT = jref.wkv_reference(*map(jnp.asarray, args))
    for want_y, want_sT in ((ty.numpy(), tsT.numpy()),
                            (np.asarray(jy), np.asarray(jsT))):
        np.testing.assert_allclose(ey.numpy(), want_y, rtol=0, atol=2e-5)
        np.testing.assert_allclose(esT.numpy(), want_sT, rtol=0, atol=2e-5)


def test_serving_ops_dispatch_by_device():
    """Registered like the training ops: CPU tensors take the plain
    version whatever ``use_kernel`` says; the CUDA wrappers refuse CPU
    tensors (tests/test_torch_gpu.py checks them on the card)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv_wkv import wkv_forward
    for op in ("attention", "rmsnorm", "wkv"):
        assert dispatch.registered()[op] == ("ref", "cuda")
    q = torch.randn(1, 2, 8, 32)
    assert torch.equal(ops.attention(q, q, q),
                       ops.attention(q, q, q, use_kernel=False))
    z = torch.zeros(1, 2, 1, 32)
    for call in (lambda: flash_attention(q, q, q),
                 lambda: rmsnorm(torch.zeros(2, 8), torch.ones(8)),
                 lambda: wkv_forward(z, z, z, z, torch.zeros(1, 32),
                                     torch.zeros(1, 1, 32, 32))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert {k: v for k, v in ops.launch_counts().items()
            if k in ("flash_attention", "rmsnorm", "wkv_forward")} == \
        dict(flash_attention=0, rmsnorm=0, wkv_forward=0)
