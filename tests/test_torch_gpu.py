"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.  Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports no JAX, so on the GPU machine it runs as

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bit-exact (tau NaN where the plain version gives NaN),
except the pass-1 moments (8 ulp: the kernel sums in f64 and rounds once,
the plain version sums in f32) and the serving kernels, which sum in
another order than their plain versions: flash attention atol 3e-5 in
f32 (the CUDA-core kernel) and, in bf16 (the tensor-core kernel), 1 bf16
ulp of the plain value plus 1e-5 (the f32 sums' difference near zero),
RMSNorm atol 1e-5 in f32 and 1 bf16 ulp, the WKV recurrence atol 2e-5.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ef_topk, ref, wire_pack
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rwkv_wkv import wkv_forward


def _leaves(seed, shape, ties):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32) * 0.05
    g = rng.standard_normal(shape).astype(np.float32)
    if ties:
        g = np.round(g * 2.0).astype(np.float32)
        m = np.zeros_like(m)
        g.reshape(-1)[:1024] = 0.0
    return m, g


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: "
                    "see the module docstring)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_ef_kernels_match_plain_on_card(cuda, ties):
    m, g = (torch.from_numpy(x).to(cuda)
            for x in _leaves(11, (300, 1024), ties))
    eta = torch.tensor([0.37], device=cuda)
    tau, mom = ef_topk.ef_stats_telemetry(m, g, eta, 10)
    rtau, rmom = ref.ef_block_stats_telemetry(m, g, eta, 10)
    torch.testing.assert_close(tau, rtau, rtol=0, atol=0)
    np.testing.assert_array_max_ulp(mom.cpu().numpy(), rmom.cpu().numpy(),
                                    maxulp=8)
    sent, mnew = ef_topk.ef_apply(m, g, eta, tau)
    rsent, rmnew = ref.ef_block_update(m, g, eta, rtau)
    torch.testing.assert_close(sent, rsent, rtol=0, atol=0)
    torch.testing.assert_close(mnew, rmnew, rtol=0, atol=0)


#: k_b at the edges of block_stats' filter widths (32, 64, 128 lane
#: values), the paper's 1%, 4% and 10% (10, 41, 102) and the whole row
SELECT_KS = [1, 10, 32, 33, 41, 102, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("k_b", SELECT_KS)
@pytest.mark.parametrize("ties", [False, True])
def test_dense_selection_kernels_match_plain_on_card(cuda, ties, k_b):
    m, x = (torch.from_numpy(v).to(cuda)
            for v in _leaves(12, (300, 1024), ties))
    eta = torch.tensor([0.37], device=cuda)
    tau = ef_topk.block_stats(x, k_b)
    torch.testing.assert_close(tau, ref.block_abs_topk_threshold(x, k_b),
                               rtol=0, atol=0)
    torch.testing.assert_close(ef_topk.ef_block_stats(m, x, eta, k_b),
                               ref.ef_block_stats(m, x, eta, k_b),
                               rtol=0, atol=0)
    sent, res = ef_topk.threshold_split(x, tau)
    rsent, rres = ref.threshold_split(x, tau)
    torch.testing.assert_close(sent, rsent, rtol=0, atol=0)
    torch.testing.assert_close(res, rres, rtol=0, atol=0)
    assert torch.equal(sent + res, x)


def _special_rows():
    """One NaN, several NaNs, +inf twice, -inf, all zeros, ties, all
    equal (as in tests/test_torch_kernels.py)."""
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


def selection_rows(k_b):
    """(kinds, rows): block rows that reach each path of block_stats'
    select at k_b (tests/test_torch_kernels.py emulates it): Gaussian
    x 1e-2 and subnormal rows (the filter for k_b <= 128); all equal, all
    zero, +0 and -0 mixed, and 300 equal maxima (more candidates than the
    filter keeps: the general path); 200 equal maxima (the filter's
    widest candidate select); 1, k_b and k_b + 3 infinities of both
    signs; NaN rows, one with an infinity; rounded ties."""
    rng = np.random.default_rng(1000 + k_b)

    def gauss():
        return (rng.standard_normal(1024) * 1e-2).astype(np.float32)

    def signs(n):
        return np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    rows = [("gauss", gauss()),
            ("subnormal", rng.integers(1, 1 << 23, 1024).astype(
                np.uint32).view(np.float32) * signs(1024)),
            ("equal", np.full(1024, -1.5, np.float32)),
            ("zeros", np.zeros(1024, np.float32)),
            ("signed_zeros", np.where(rng.random(1024) < 0.5, 0.0,
                                      -0.0).astype(np.float32)),
            ("rounded", np.round(gauss() * 200.0))]
    for kind, n in (("ties_under_cap", 200), ("ties_over_cap", 300)):
        x = gauss()
        x[rng.choice(1024, n, replace=False)] = signs(n)
        rows.append((kind, x))
    for n in (1, k_b, min(k_b + 3, 1024)):
        x = gauss()
        x[rng.choice(1024, n, replace=False)] = np.inf * signs(n)
        rows.append((f"inf{n}", x))
    x = gauss()
    x[rng.integers(1024)] = np.nan
    rows.append(("nan", x))
    x = gauss()
    x[[3, 700]] = np.nan
    x[10] = -np.inf
    rows.append(("nan_inf", x))
    return [k for k, _ in rows], np.stack([r for _, r in rows]).astype(
        np.float32)


def _lowest_bit_exponent(x):
    """e with 2^e the lowest set bit of each finite nonzero f32 x."""
    b = x.view(np.uint32) & np.uint32(0x7fffffff)
    e = (b >> 23).astype(np.int64)
    mant = (b & 0x7fffff).astype(np.int64)
    mant = np.where(e > 0, mant | 0x800000, mant)
    mant = np.where(mant == 0, 1, mant)
    return np.where(e > 0, e - 150, -149) + np.log2(mant & -mant).astype(
        np.int64)


def ef_inputs(x, eta, seed):
    """(m, g) f32 whose EF accumulators fma(eta, g, m) are the rows x bit
    for bit (any NaN for a NaN), made by cancellation: for finite nonzero
    x, g = +-2^j with j = (x's lowest bit) - (eta's exponent) + 23, so
    eta*g and m = x - eta*g are exact multiples of x's lowest bit below
    2^24 of it, and the fma gives x back; +0 from m = -eta*g, -0 from
    m = g = -0; inf and NaN from m = x with a Gaussian g."""
    rng = np.random.default_rng(seed)
    e = np.float32(eta)
    finite = np.isfinite(x) & (x != 0)
    j = np.where(finite, _lowest_bit_exponent(x) - (np.frexp(e)[1] - 1)
                 + 23, rng.integers(-20, 20, x.shape))
    g = np.ldexp(np.where(np.signbit(x), -1.0, 1.0), j)
    g = np.where(np.isfinite(x), g, rng.standard_normal(x.shape))
    g = np.where((x == 0) & np.signbit(x), -0.0, g).astype(np.float32)
    m = np.where(np.isfinite(x) & ~((x == 0) & np.signbit(x)),
                 x.astype(np.float64) - np.float64(e) * g, x).astype(
                     np.float32)
    acc = ref.ef_acc(torch.from_numpy(m), torch.from_numpy(g),
                     torch.tensor([e])).numpy()
    assert ((acc.view(np.uint32) == x.view(np.uint32))
            | (np.isnan(acc) & np.isnan(x))).all()
    return m, g


def pass1_rows(k_b, eta=0.0345):
    """(kinds, m, g): the rows of selection_rows(k_b) as the accumulators
    fma(eta, g, m) of EF pass 1 (ef_inputs: ties, zeros and subnormals
    made by cancellation), then 'inf_minus_inf', whose NaN the fma makes
    from m = +inf and g = -inf, and 'trainer', drawn as the trainer's m ~
    N(0, 1e-3) and g ~ N(0, 1e-2), which the fma rounds."""
    kinds, x = selection_rows(k_b)
    m, g = ef_inputs(x, eta, 2000 + k_b)
    rng = np.random.default_rng(3000 + k_b)
    inf_m = (rng.standard_normal(1024) * 1e-3).astype(np.float32)
    inf_g = (rng.standard_normal(1024) * 1e-2).astype(np.float32)
    inf_m[[5, 900]], inf_g[[5, 900]] = np.inf, -np.inf
    tr_m = (rng.standard_normal(1024) * 1e-3).astype(np.float32)
    tr_g = (rng.standard_normal(1024) * 1e-2).astype(np.float32)
    return kinds + ["inf_minus_inf", "trainer"], \
        np.concatenate([m, inf_m[None], tr_m[None]]), \
        np.concatenate([g, inf_g[None], tr_g[None]])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 9, 300])
@pytest.mark.parametrize("k_b", SELECT_KS)
def test_ef_pass1_select_paths_on_card(cuda, k_b, rows):
    """Both EF pass-1 kernels on the accumulator rows that reach each path
    of the select (pass1_rows), cycled to a row count ragged against the
    kernels' 8 warps a block: tau bit-exact, NaN exactly where a row's
    accumulator holds a NaN; the moments within 8 ulp where finite and
    equal (NaN as NaN) elsewhere."""
    _, m, g = pass1_rows(k_b)
    m, g = (torch.from_numpy(np.resize(t, (rows, 1024))).to(cuda)
            for t in (m, g))
    eta = torch.tensor([0.0345], device=cuda)
    tau, mom = ef_topk.ef_stats_telemetry(m, g, eta, k_b)
    rtau, rmom = ref.ef_block_stats_telemetry(m, g, eta, k_b)
    torch.testing.assert_close(tau, rtau, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(ef_topk.ef_block_stats(m, g, eta, k_b), rtau,
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(tau.isnan().ravel(),
                       ref.ef_acc(m, g, eta).isnan().any(1))
    fin = rmom.isfinite()
    np.testing.assert_array_max_ulp(mom[fin].cpu().numpy(),
                                    rmom[fin].cpu().numpy(), maxulp=8)
    torch.testing.assert_close(mom[~fin], rmom[~fin], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 9, 300])
@pytest.mark.parametrize("k_b", [1, 10, 31, 32, 33, 41, 102, 1023, 1024])
def test_block_stats_select_paths_on_card(cuda, k_b, rows):
    """The rows that reach each path of the select, cycled to a row count
    ragged against the kernel's 8 warps a block: bit-exact, NaN where the
    plain version gives NaN."""
    kinds, x = selection_rows(k_b)
    x = torch.from_numpy(np.resize(x, (rows, 1024))).to(cuda)
    torch.testing.assert_close(ef_topk.block_stats(x, k_b),
                               ref.block_abs_topk_threshold(x, k_b),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("k_b", SELECT_KS)
def test_pass1_kernels_nan_rule_on_card(cuda, k_b):
    x = torch.from_numpy(_special_rows()).to(cuda)
    m = torch.zeros_like(x)
    eta = torch.tensor([0.5], device=cuda)
    tau = ef_topk.block_stats(x, k_b)
    assert torch.isnan(tau[1:3]).all()
    torch.testing.assert_close(tau, ref.block_abs_topk_threshold(x, k_b),
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(ef_topk.ef_block_stats(m, x, eta, k_b),
                               ref.ef_block_stats(m, x, eta, k_b),
                               rtol=0, atol=0, equal_nan=True)
    t2, _ = ef_topk.ef_stats_telemetry(m, x, eta, k_b)
    torch.testing.assert_close(t2, ref.ef_block_stats_telemetry(
        m, x, eta, k_b)[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("ragged", [False, True])
def test_wire_kernels_match_plain_on_card(cuda, bits, ragged):
    rng = np.random.default_rng(bits)
    F = 32 // bits
    fields = torch.from_numpy(rng.integers(
        0, 2**32, (9, 40 * F), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(cuda)
    counts = torch.from_numpy(rng.integers(0, 30, 9).astype(
        np.int32)).to(cuda) if ragged else None
    period = 29 if ragged else 0
    words = wire_pack.pack_words(fields, bits, counts, period)
    torch.testing.assert_close(words, ref.pack_fields(fields, bits, counts,
                                                      period),
                               rtol=0, atol=0)
    back = wire_pack.unpack_words(words, bits, counts, period)
    torch.testing.assert_close(back, ref.unpack_fields(words, bits, counts,
                                                       period),
                               rtol=0, atol=0)


def _wire_roundtrip(x, bits, counts=None, period=0, pack=True):
    """Run one wire kernel on ``x`` and hold it bit-exact against its
    plain version."""
    if pack:
        got = wire_pack.pack_words(x, bits, counts, period)
        want = ref.pack_fields(x, bits, counts, period)
    else:
        got = wire_pack.unpack_words(x, bits, counts, period)
        want = ref.unpack_fields(x, bits, counts, period)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _int32_patterns(seed, n, cuda):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("offset", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("pack", [True, False])
def test_wire_kernels_misaligned_head_on_card(cuda, bits, offset, pack):
    """The input's base ``offset`` int32s past a 16-byte boundary (a word
    view sliced at any word, a field view at any field): the kernels pick
    a head of scalar words or their scalar path, bit-exact either way."""
    F = 32 // bits if pack else 1
    rows, cols = 7, 300
    buf = _int32_patterns(offset, offset + rows * cols * F, cuda)
    _wire_roundtrip(buf[offset:].view(rows, cols * F), bits, pack=pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("words", [1, 3, 127, 129, 1015, 4099])
@pytest.mark.parametrize("pack", [True, False])
def test_wire_kernels_odd_tail_on_card(cuda, bits, words, pack):
    """Streams of lengths that are no multiple of 4 words (or of a
    warp's 128-word tile): the tail is packed one word a thread."""
    F = 32 // bits if pack else 1
    x = _int32_patterns(words, words * F, cuda).view(1, words * F)
    _wire_roundtrip(x, bits, pack=pack)


@pytest.mark.gpu
def test_wire_kernels_gamma_01_stream_on_card(cuda):
    """The trainer's 16-bit index stream at gamma 0.1 (k_b 102): 5,483,520
    words in the (rows, 512)-word layout it is packed in, more than a few
    waves of the grid, so the blocks stride; round trip exact too."""
    rows, cols = wire_pack.stream_shape(5_483_520)
    fields = _int32_patterns(102, rows * cols * 2, cuda).view(rows, cols * 2)
    words = wire_pack.pack_words(fields, 16)
    torch.testing.assert_close(words, ref.pack_fields(fields, 16),
                               rtol=0, atol=0)
    back = wire_pack.unpack_words(words, 16)
    torch.testing.assert_close(back, ref.unpack_fields(words, 16),
                               rtol=0, atol=0)
    torch.testing.assert_close(back, fields & 0xFFFF, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 9, 70_000])
@pytest.mark.parametrize("pack", [True, False])
def test_wire_kernels_ragged_4bit_on_card(cuda, rows, pack):
    """The ragged variant at 4 bits with a period (29) that divides
    neither the row (40 words, 320 fields) nor the 8 fields of a word,
    and more rows than grid y holds (70,000 > 65,535)."""
    rng = np.random.default_rng(rows)
    counts = torch.from_numpy(rng.integers(-1, 31, rows).astype(
        np.int32)).to(cuda)
    x = _int32_patterns(rows, rows * 40 * (8 if pack else 1), cuda)
    _wire_roundtrip(x.view(rows, -1), 4, counts, 29, pack=pack)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors of one
    sign pattern (the int16 bit patterns are monotone per sign)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def _check_rmsnorm(cuda, shape, xdt, wdt):
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, xdt)
    w = torch.from_numpy(rng.standard_normal(shape[-1]).astype(
        np.float32)).to(cuda, wdt)
    got = rmsnorm(x, w, 1e-5)
    want = ref.rmsnorm_reference(x, w, 1e-5)
    assert got.dtype == xdt
    if xdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        assert _bf16_ulps(got, want) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (200, 256), (21, 512),
                                   (4, 2560)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, xdt, wdt):
    _check_rmsnorm(cuda, shape, xdt, wdt)


def _bf16_ulp_err(got: torch.Tensor, want: torch.Tensor,
                  atol: float) -> float:
    """Largest |got - want| in bf16 ulps of |want|, once ``atol`` is
    taken off."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp(min=atol)).exponent - 8)
    return float(((got.float() - w).abs() - atol).clamp(min=0).div(ulp)
                 .max())


def _qkv(seed, B, H, Sq, Sk, D, dtype, cuda):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    return [torch.from_numpy(t).to(cuda, dtype) for t in (q, k, v)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D", [(1, 2, 128, 128, 32),
                                         (2, 3, 100, 100, 64),
                                         (1, 2, 37, 150, 128),
                                         (2, 2, 1, 70, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_kernel_matches_plain_on_card(cuda, B, H, Sq, Sk, D,
                                                      causal, window):
    q, k, v = _qkv(Sq + Sk, B, H, Sq, Sk, D, torch.float32, cuda)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_kernel_bf16_strided_on_card(cuda, D):
    """bf16 through the transposed (B, S, H, D) views the model passes."""
    B, S, H = 2, 200, 3
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
        for _ in range(3))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = ref.mha_reference(q, k, v, causal=True)
    assert _bf16_ulp_err(got, want, 1e-5) <= 1


def _bshd_views(seed, B, H, Sq, Sk, D, cuda):
    """bf16 q, k, v as the model hands them over: (B, H, S, D) views of
    (B, S, H, D) tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
        for S in (Sq, Sk, Sk)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Sk,D", [(1, 2, 1, 70, 64),
                                         (2, 3, 100, 100, 64),
                                         (1, 2, 37, 150, 128),
                                         (2, 2, 300, 300, 32),
                                         (1, 4, 77, 333, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_tensor_core_route_matches_plain_on_card(
        cuda, B, H, Sq, Sk, D, causal, window):
    """The bf16 route (wgmma, TMA) at shapes that cross every tile edge:
    Sq and Sk off the 128-query and 64-key tiles, Sq < Sk, one query."""
    q, k, v = _bshd_views(Sq * 7 + Sk, B, H, Sq, Sk, D, cuda)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulp_err(got, want, 1e-5) <= 1


@pytest.mark.gpu
def test_flash_attention_tensor_core_route_takes_broadcast_heads(cuda):
    """k and v broadcast over heads (head stride 0) and over a size-1
    batch: the tensor maps read those axes at coordinate 0."""
    q, k, v = _bshd_views(5, 2, 4, 90, 90, 128, cuda)
    kb, vb = (t[:1, :1].expand(2, 4, 90, 128) for t in (k, v))
    assert kb.stride(1) == 0 and kb.stride(0) == 0
    got = flash_attention(q, kb, vb, causal=True)
    want = ref.mha_reference(q, kb, vb, causal=True)
    assert _bf16_ulp_err(got, want, 1e-5) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "flash_attention_kernel"),
    (torch.bfloat16, "flash_attention_sm90_kernel")])
def test_flash_attention_route_follows_dtype_on_card(cuda, dtype, kernel):
    """f32 launches the CUDA-core kernel, bf16 the tensor-core one; both
    count in flash_attention.launches."""
    q, k, v = _qkv(3, 1, 2, 64, 64, 64, dtype, cuda)
    flash_attention(q, k, v)                    # built and loaded
    before = flash_attention.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    ran = {n for n in ("flash_attention_kernel", "flash_attention_sm90_kernel")
           if any(re.search(rf"\b{n}\b", key) for key in names)}
    assert ran == {kernel}, names
    assert flash_attention.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2056, 5120])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_rmsnorm_wide_rows_match_plain_on_card(cuda, d, xdt, wdt):
    """D = 2056 (a multiple of 8, not of 256: lanes hold unequal chunk
    counts) in registers, and D = 5120, past the register path's 4096,
    through the streaming kernel."""
    _check_rmsnorm(cuda, (37, d), xdt, wdt)


def _wkv_args(cuda, seed, B, S, H, K, V, offset=0):
    """Inputs drawn as the model draws them; ``offset`` > 0 puts r, k, v
    and w that many floats into their storage, off 16-byte alignment."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k = f(B, S, H, K) * 0.3, f(B, S, H, K) * 0.3
    v = f(B, S, H, V)
    w = 1.0 / (1.0 + np.exp(-f(B, S, H, K)))
    u, s0 = f(H, K) * 0.1, f(B, H, K, V) * 0.1

    def put(t, off):
        t = np.ascontiguousarray(t, np.float32).reshape(-1)
        base = torch.zeros(t.size + off, device=cuda)
        base[off:] = torch.from_numpy(t).to(cuda)
        return base[off:]
    shapes = ((B, S, H, K), (B, S, H, K), (B, S, H, V), (B, S, H, K),
              (H, K), (B, H, K, V))
    return [put(t, offset if i < 4 else 0).view(shape)
            for i, (t, shape) in enumerate(zip((r, k, v, w, u, s0),
                                               shapes))]


def _check_wkv(args):
    y, sT = wkv_forward(*args)
    ry, rsT = ref.wkv_reference(*args)
    torch.testing.assert_close(y, ry, rtol=0, atol=2e-5)
    torch.testing.assert_close(sT, rsT, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8, 31, 32, 33, 65, 70, 1024])
@pytest.mark.parametrize("K", [32, 64])
def test_wkv_kernel_matches_plain_on_card(cuda, S, K):
    """S around the 32-step staging chunk (31, 32, 33: one partial, one
    full and a full plus one step; 65: both buffers and a partial third
    chunk) and 1024 steps, rwkv6-1.6b's prefill length."""
    _check_wkv(_wkv_args(cuda, S * K, 2, S, 3, K, K))


@pytest.mark.gpu
@pytest.mark.parametrize("V", [16, 50, 100])
@pytest.mark.parametrize("K", [32, 64])
def test_wkv_kernel_value_width_on_card(cuda, V, K):
    """V != K and not a multiple of the 64 columns a block holds: 16
    leaves most of a block idle, 100 a ragged second block, 50 (not a
    multiple of 4) takes the 4-byte copies."""
    _check_wkv(_wkv_args(cuda, V + K, 2, 65, 3, K, V))


@pytest.mark.gpu
def test_wkv_kernel_unaligned_inputs_on_card(cuda):
    """r, k, v and w one float off 16-byte alignment take the 4-byte
    copies."""
    args = _wkv_args(cuda, 5, 2, 40, 3, 64, 64, offset=1)
    assert args[0].data_ptr() % 16 != 0
    _check_wkv(args)


@pytest.mark.gpu
def test_wkv_kernel_empty_sequence_on_card(cuda):
    """seq = 0 gives sT == s0 and writes neither s0 nor the inputs."""
    args = _wkv_args(cuda, 6, 2, 0, 3, 64, 64)
    before = [t.clone() for t in args]
    y, sT = wkv_forward(*args)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 3, 64)
    assert torch.equal(sT, args[5])
    for t, b in zip(args, before):
        assert torch.equal(t, b)


@pytest.mark.gpu
def test_serving_wrappers_refuse_cpu_tensors_and_gradients(cuda):
    q = torch.zeros((1, 1, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros((2, 8)), torch.ones(8))
    z = torch.zeros((1, 2, 1, 32))
    with pytest.raises(ValueError):
        wkv_forward(z, z, z, z, torch.zeros((1, 32)),
                    torch.zeros((1, 1, 32, 32)))
    qc = q.to(cuda).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(qc, qc, qc)
    x = torch.zeros((2, 8), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        rmsnorm(x, torch.ones(8, device=cuda))
    zc = z.to(cuda).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        wkv_forward(zc, zc, zc, zc, torch.zeros((1, 32), device=cuda),
                    torch.zeros((1, 1, 32, 32), device=cuda))
    with torch.inference_mode():        # the serving path's mode
        assert flash_attention(qc, qc, qc).shape == q.shape


# --------------------------------------------------------------------------
# the adaptive budget: the ragged per-row codec and the perleaf exchange
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("value_bits", [4, 8, 16, 32])
@pytest.mark.parametrize("method", ["block_topk", "topk"])
def test_ragged_row_codec_on_card(cuda, method, value_bits):
    """``encode_rows`` / ``decode_rows`` of ragged rows through the ragged
    kernels, bit for bit against the plain versions on the CPU, at counts
    that differ per row and under a header that says less than the rows
    hold; each section below 32 bits is one ragged launch each way."""
    from repro_torch.comm import wire
    from repro_torch.core.compression import Compressor, \
        block_extract_sparse
    from repro_torch.core.leafmath import per_layer_topk
    from repro_torch.kernels import ops
    comp = Compressor(gamma=0.02, max_gamma=0.05, method=method,
                      value_bits=value_bits)
    rng = np.random.default_rng(value_bits)
    x = torch.from_numpy(np.round(rng.standard_normal((6, 3000)) * 3)
                         .astype(np.float32))
    vals, idx = (block_extract_sparse(x, comp) if method == "block_topk"
                 else per_layer_topk(x, comp.k_for(3000)))
    spec = wire.WireSpec.for_row(comp, 3000)
    full = spec.full_count
    counts = torch.tensor([0, full, full // 2, 1, full - 1, 3],
                          dtype=torch.int32)
    want = wire.encode_rows(vals, idx, spec, counts=counts)
    ops.reset_launch_counts()
    got = wire.encode_rows(vals.to(cuda), idx.to(cuda), spec,
                           counts=counts.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    kernels = (value_bits < 32) + 1
    assert ops.launch_counts()["pack_words_ragged"] == kernels
    for header in (counts, counts // 2):
        words = want.clone()
        words[:, 0] = header
        rv, ri = wire.decode_rows(words, spec)
        gv, gi = wire.decode_rows(words.to(cuda), spec)
        torch.testing.assert_close(gv.cpu(), rv, rtol=0, atol=0)
        torch.testing.assert_close(gi.cpu(), ri, rtol=0, atol=0)
    counts = ops.launch_counts()
    assert counts["unpack_words_ragged"] == 2 * kernels
    assert counts["pack_words"] == counts["unpack_words"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("value_bits", [8, 32])
def test_perleaf_exchange_on_card(cuda, value_bits):
    """The perleaf exchange at a 10% budget and gamma_t 0.04 on the card
    against the plain versions on the CPU, and against the bucketed
    exchange on the card: updates, EF memory and bytes bit for bit (one
    worker: every scattered index is hit once, padding adds zeros),
    telemetry rel 1e-5 (the pass-1 moments sum in f64 on the card).  One
    fused-EF pair and one ragged pack/unpack launch per section and per
    compressed leaf; the bucketed exchange launches no ragged kernel."""
    import socket

    import torch.distributed as dist
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 4096)), "b": rng.standard_normal(
        (5000,)), "tiny": rng.standard_normal((50,)),
        "c": rng.standard_normal((2, 4, 900))}
    tree = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}
    mem = {k: 0.05 * torch.flip(v, [-1]) for k, v in tree.items()}
    comp = Compressor(gamma=0.01, max_gamma=0.1, method="block_topk",
                      value_bits=value_bits, min_compress_size=64)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def run(device, transport):
            return worker_compress_aggregate(
                {k: v.to(device) for k, v in tree.items()},
                {k: v.to(device) for k, v in mem.items()}, np.float32(0.7),
                comp, gamma_t=np.float32(0.04), transport=transport)
        want = run("cpu", "perleaf")
        ops.reset_launch_counts()
        got = run(cuda, "perleaf")
        counts = ops.launch_counts()
        bucketed = run(cuda, "bucketed")
        after = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    sections = 1 + (value_bits < 32)
    assert counts == dict(counts, ef_stats_telemetry=3, ef_apply=3,
                          pack_words_ragged=3 * sections,
                          unpack_words_ragged=3 * sections)
    assert sum(counts.values()) == 6 + 6 * sections
    assert after["pack_words_ragged"] == counts["pack_words_ragged"]
    for out in (got, bucketed):
        for i in (0, 1):
            for k in tree:
                torch.testing.assert_close(out[i][k].cpu(), want[i][k],
                                           rtol=0, atol=0)
        assert (out[2], out[3]) == (want[2], want[3])
        for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
            torch.testing.assert_close(getattr(out[4], f).cpu(),
                                       getattr(want[4], f), rtol=1e-5,
                                       atol=0)


# --------------------------------------------------------------------------
# the trainer beyond one step: local steps, bf16 EF memory, checkpoints
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("opt_kw,micro", [
    (dict(local_steps=2), 2), (dict(local_steps=2, kind="nonadaptive"), 2),
    (dict(ef_dtype="bfloat16"), 1)], ids=["local-steps", "local-nonadaptive",
                                          "bf16-ef"])
def test_trainer_rounds_on_card(cuda, opt_kw, micro, tmp_path):
    """Two rounds of the smoke trainer on the card: one launch of each
    training kernel a round (a local-steps round exchanges once), bf16
    EF memory leaves where asked, the bytes and, within rel 1e-4, the
    losses of the CPU's plain path; then the state saved from the card
    and restored onto it, bit for bit."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    run = RunConfig(model=get_smoke_config("paper-lm-100m"),
                    shape=ShapeConfig(33, 4), microbatches=micro,
                    optimizer=OptimizerConfig(
                        compressor=Compressor(gamma=0.01,
                                              method="block_topk"),
                        **opt_kw))
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=33,
                         global_batch=4)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # one group for both runs: gloo for the CPU's, NCCL for the card's
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        logs = {}
        for dev in ("cpu", cuda):
            params = lm.init_params(run.model, seed=0, device=dev)
            state = init_train_state(params, run)
            ops.reset_launch_counts()
            logs[str(dev)] = []
            for t in range(2):
                batch = {k: v.to(dev) for k, v in pipe.batch(t).items()}
                params, state, m = train_step(params, state, batch, run)
                logs[str(dev)].append(m)
            counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts == dict(dict.fromkeys(counts, 0), ef_stats_telemetry=2,
                          ef_apply=2, pack_words=2, unpack_words=2)
    want_dt = getattr(torch, opt_kw.get("ef_dtype", "float32"))
    assert all(x.dtype == want_dt and x.is_cuda
               for x in tree_leaves(state.memory))
    for a, b in zip(logs[str(cuda)], logs["cpu"]):
        assert a["wire_bytes"] == b["wire_bytes"]
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
        assert a["n_evals"] >= 1
    tree = {"params": params, "state": state}
    ckpt.save(str(tmp_path), state.step, tree)
    skel = lm.init_params(run.model, seed=1, device=cuda)
    out, _ = ckpt.restore(str(tmp_path), {
        "params": skel, "state": init_train_state(skel, run)})
    assert dataclasses.replace(out["state"], memory=None) == \
        dataclasses.replace(state, memory=None)
    for a, b in zip(tree_leaves(tree["params"]) + tree_leaves(state.memory),
                    tree_leaves(out["params"])
                    + tree_leaves(out["state"].memory)):
        assert b.is_cuda and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


# --------------------------------------------------------------------------
# ACGD and the compressed downlink
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("transport,value_bits", [("bucketed", 32),
                                                  ("perleaf", 8)])
def test_downlink_exchange_on_card(cuda, transport, value_bits):
    """One exchange with the server round at a 10% budget (uplink gamma_t
    0.04, downlink 0.02) on the card against the plain versions on the
    CPU: updates, EF memory, server memory and both directions' bytes bit
    for bit; the server round launches no kernel (the counts equal the
    exchange's without it)."""
    import socket

    import torch.distributed as dist
    from repro_torch.comm import downlink as dl
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4096)), "b": rng.standard_normal(
        (5000,)), "tiny": rng.standard_normal((50,)),
        "c": rng.standard_normal((2, 4, 900))}
    tree = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}
    mem = {k: 0.05 * torch.flip(v, [-1]) for k, v in tree.items()}
    comp = Compressor(gamma=0.01, max_gamma=0.1, method="block_topk",
                      value_bits=value_bits, min_compress_size=64)
    shapes = [tree[k].shape for k in sorted(tree)]
    stacked = [tree[k].dim() >= 2 for k in sorted(tree)]
    server = dl.init_downlink_state(shapes, stacked, comp, 0.02)
    server = dl.DownlinkState(
        0.01 * torch.randn(server.memory.shape,
                           generator=torch.Generator().manual_seed(2)),
        server.gamma)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def run(device, with_server=True):
            ctx = dl.DownlinkCtx(dl.DownlinkState(
                server.memory.to(device), server.gamma)) \
                if with_server else None
            return worker_compress_aggregate(
                {k: v.to(device) for k, v in tree.items()},
                {k: v.to(device) for k, v in mem.items()}, np.float32(0.7),
                comp, gamma_t=np.float32(0.04), transport=transport,
                downlink_ctx=ctx)
        want = run("cpu")
        ops.reset_launch_counts()
        got = run(cuda)
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        run(cuda, with_server=False)
        plain = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts == plain and sum(counts.values()) > 0
    for i in (0, 1):
        for k in tree:
            torch.testing.assert_close(got[i][k].cpu(), want[i][k],
                                       rtol=0, atol=0)
    assert got[2:4] == want[2:4]
    torch.testing.assert_close(got[5].state.memory.cpu(),
                               want[5].state.memory, rtol=0, atol=0)
    assert got[5][1:] == want[5][1:] and got[5].state.memory.is_cuda
    assert got[5].eff_wire_bytes < got[5].wire_bytes


@pytest.mark.gpu
def test_roundtrip_rows_matches_the_codec_on_card(cuda):
    """``roundtrip_rows`` on the card equals ``decode_rows(encode_rows)``
    through the CUDA codec and the CPU's plain round trip, bit for bit:
    32- and 8-bit block-local rows, ragged rows at per-row counts."""
    from repro_torch.comm import wire
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import compress_leaf
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 5000)).astype(np.float32))
    for kw, counts in ((dict(gamma=0.01), None),
                       (dict(gamma=0.01, value_bits=8), None),
                       (dict(gamma=0.04, max_gamma=0.1, value_bits=8),
                        [41, 1, 102, 57])):
        comp = Compressor(method="block_topk", **kw)
        spec = wire.WireSpec.for_row(comp, 5000)
        c = None if counts is None else torch.tensor(counts,
                                                     dtype=torch.int32)
        vals, idx, _ = compress_leaf(x, comp, True)
        want = wire.roundtrip_rows(vals, idx, spec, counts=c)
        gv, gi, cc = vals.to(cuda), idx.to(cuda), \
            None if c is None else c.to(cuda)
        got = wire.roundtrip_rows(gv, gi, spec, counts=cc)
        lit = wire.decode_rows(wire.encode_rows(gv, gi, spec, counts=cc),
                               spec)
        for a, b in ((got, want), (got, lit)):
            torch.testing.assert_close(a[0].cpu(), b[0].cpu(), rtol=0,
                                       atol=0)
            torch.testing.assert_close(a[1].cpu(), b[1].cpu(), rtol=0,
                                       atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("opt_kw", [
    dict(kind="acgd"), dict(downlink="compressed"),
    dict(kind="acgd", downlink="compressed", transport="perleaf")],
    ids=["acgd", "downlink", "acgd-downlink-perleaf"])
def test_acgd_and_downlink_rounds_on_card(cuda, opt_kw, tmp_path):
    """Two rounds of the smoke trainer on the card: one launch of each
    training kernel a round (perleaf: one pair and one codec pair a
    compressed leaf), none more for the downlink; bytes both ways equal
    the CPU's and losses within rel 1e-4; the velocity and the server
    memory f32 on the card, saved and restored onto it bit for bit."""
    import socket

    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    run = RunConfig(model=get_smoke_config("paper-lm-100m"),
                    shape=ShapeConfig(33, 4),
                    optimizer=OptimizerConfig(
                        compressor=Compressor(gamma=0.01,
                                              method="block_topk"),
                        **opt_kw))
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=33,
                         global_batch=4)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        logs = {}
        for dev in ("cpu", cuda):
            params = lm.init_params(run.model, seed=0, device=dev)
            state = init_train_state(params, run)
            ops.reset_launch_counts()
            logs[str(dev)] = []
            for t in range(2):
                batch = {k: v.to(dev) for k, v in pipe.batch(t).items()}
                params, state, m = train_step(params, state, batch, run)
                logs[str(dev)].append(m)
            counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    n = 1
    if opt_kw.get("transport") == "perleaf":
        from repro_torch.comm.downlink import downlink_plan
        from repro_torch.utils import tree_flatten
        n = len(downlink_plan(
            [p.shape for p in tree_leaves(params)],
            tree_flatten(lm.stacked_mask(params))[0],
            run.optimizer.compressor).compressed_ids)
    assert counts == dict(dict.fromkeys(counts, 0), ef_stats_telemetry=2 * n,
                          ef_apply=2 * n, pack_words=2 * n,
                          unpack_words=2 * n)
    keys = ("wire_bytes", "effective_wire_bytes", "cum_effective_wire_bytes",
            "downlink_wire_bytes", "downlink_effective_wire_bytes")
    for a, b in zip(logs[str(cuda)], logs["cpu"]):
        assert [a.get(k) for k in keys] == [b.get(k) for k in keys]
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    def carried_of(st):
        return (tree_leaves(st.velocity) if st.velocity is not None
                else []) + ([st.downlink.memory] if st.downlink is not None
                            else [])
    carried = carried_of(state)
    assert carried and all(x.dtype == torch.float32 and x.is_cuda
                           for x in carried)
    ckpt.save(str(tmp_path), state.step, {"params": params, "state": state})
    skel = lm.init_params(run.model, seed=1, device=cuda)
    out, _ = ckpt.restore(str(tmp_path), {
        "params": skel, "state": init_train_state(skel, run)})
    back = carried_of(out["state"])
    assert len(back) == len(carried)
    for a, b in zip(carried, back):
        assert b.is_cuda and torch.equal(a, b)
    if state.downlink is not None:
        assert out["state"].downlink.gamma == state.downlink.gamma


# --------------------------------------------------------------------------
# the overlap transport: chunked ring, delay-1 double buffer
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("value_bits", [8, 32])
def test_overlap_exchange_on_card(cuda, delay, value_bits):
    """Two overlap exchanges at a 10% budget (gamma_t 0.04, then 0.07) on
    the card against the plain versions on the CPU: updates, EF memory,
    bytes and the carried payload bit for bit; each launches what the
    bucketed exchange launches (the delay-1 own-row round trip adds
    none); at delay 1 the first update is zero."""
    import socket

    import torch.distributed as dist
    from repro_torch.comm import overlap as ov
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((3, 4096)), "b": rng.standard_normal(
        (5000,)), "tiny": rng.standard_normal((50,)),
        "c": rng.standard_normal((2, 4, 900))}
    tree = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}
    mem = {k: 0.05 * torch.flip(v, [-1]) for k, v in tree.items()}
    comp = Compressor(gamma=0.01, max_gamma=0.1, method="block_topk",
                      value_bits=value_bits, min_compress_size=64)
    cfg = ov.OverlapConfig(n_chunks=3, delay=delay)
    shapes = [tree[k].shape for k in sorted(tree)]
    stacked = [tree[k].dim() >= 2 for k in sorted(tree)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def rounds(device, transport):
            st = ov.init_overlap_state(shapes, stacked, comp, device=device)
            m = {k: v.to(device) for k, v in mem.items()}
            outs, counts = [], []
            for r, gt in enumerate((0.04, 0.07)):
                ops.reset_launch_counts()
                out = worker_compress_aggregate(
                    {k: (v * (1 + r)).to(device) for k, v in tree.items()},
                    m, np.float32(0.7), comp, gamma_t=np.float32(gt),
                    transport=transport,
                    transport_ctx=None if transport == "bucketed" else
                    ov.OverlapCtx(cfg, st))
                counts.append(ops.launch_counts())
                m = out[1]
                if transport == "overlap":
                    st = out[5]
                outs.append(out)
            return outs, counts
        want, _ = rounds("cpu", "overlap")
        got, counts = rounds(cuda, "overlap")
        _, bucketed = rounds(cuda, "bucketed")
    finally:
        dist.destroy_process_group()
    assert counts == bucketed and all(sum(c.values()) > 0 for c in counts)
    assert all(c["pack_words_ragged"] == c["unpack_words_ragged"] == 0
               for c in counts)
    for g, w in zip(got, want):
        for i in (0, 1):
            for k in tree:
                torch.testing.assert_close(g[i][k].cpu(), w[i][k], rtol=0,
                                           atol=0)
        assert g[2:4] == w[2:4]
        assert g[5].payload.is_cuda and torch.equal(g[5].payload.cpu(),
                                                    w[5].payload)
        torch.testing.assert_close(g[5].dense.cpu(), w[5].dense, rtol=0,
                                   atol=0)
        assert (g[5].eff_wire, g[5].seeded) == (w[5].eff_wire, 1.0)
    if delay:
        assert not any(got[0][0][k].any() for k in tree)


# --------------------------------------------------------------------------
# the gossip transport at one worker
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("value_bits", [8, 32])
def test_gossip_exchange_on_card(cuda, value_bits):
    """Two gossip exchanges at one worker (ring(1): no edge) on the card
    against the plain versions on the CPU, and against bucketed on the
    card: updates, EF memory and bytes bit for bit, (v, lr) at (0, 1) on
    the card, bucketed's launches, and no collective at all (bucketed
    all-gathers and all-reduces on one rank)."""
    import socket

    import torch.distributed as dist
    from repro_torch.comm import gossip as gs
    from repro_torch.comm.topology import build_topology
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((3, 4096)), "b": rng.standard_normal(
        (5000,)), "tiny": rng.standard_normal((50,)),
        "c": rng.standard_normal((2, 4, 900))}
    tree = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}
    mem = {k: 0.05 * torch.flip(v, [-1]) for k, v in tree.items()}
    comp = Compressor(gamma=0.01, method="block_topk",
                      value_bits=value_bits, min_compress_size=64)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    collectives = []
    real = {n: getattr(dist, n) for n in ("all_gather_into_tensor",
                                          "all_reduce", "batch_isend_irecv")}

    def counting(name):
        return lambda *a, **k: collectives.append(name) or real[name](*a,
                                                                      **k)
    try:
        def rounds(device, transport):
            st = gs.GossipState.init(device)
            m = {k: v.to(device) for k, v in mem.items()}
            outs, counts, calls = [], [], []
            for r in range(2):
                ops.reset_launch_counts()
                collectives.clear()
                out = worker_compress_aggregate(
                    {k: (v * (1 + r)).to(device) for k, v in tree.items()},
                    m, np.float32(0.7), comp, transport=transport,
                    transport_ctx=None if transport == "bucketed" else
                    gs.GossipCtx(build_topology("ring", 1),
                                 gs.GossipConfig(), st))
                counts.append(ops.launch_counts())
                calls.append(list(collectives))
                m = out[1]
                if transport == "gossip":
                    st = out[5]
                outs.append(out)
            return outs, counts, calls
        for n in real:
            setattr(dist, n, counting(n))
        want, _, _ = rounds("cpu", "gossip")
        got, counts, calls = rounds(cuda, "gossip")
        buck, b_counts, b_calls = rounds(cuda, "bucketed")
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
        dist.destroy_process_group()
    assert counts == b_counts and all(sum(c.values()) > 0 for c in counts)
    assert all(c["pack_words_ragged"] == c["unpack_words_ragged"] == 0
               for c in counts)
    assert calls == [[], []] and all(b_calls)
    for g, w, b in zip(got, want, buck):
        for i in (0, 1):
            for k in tree:
                torch.testing.assert_close(g[i][k].cpu(), w[i][k], rtol=0,
                                           atol=0)
                torch.testing.assert_close(g[i][k], b[i][k], rtol=0,
                                           atol=0)
        assert g[2:4] == w[2:4] == b[2:4]
        assert g[5].v.is_cuda and float(g[5].v) == 0.0
        assert float(g[5].lr) == 1.0


@pytest.mark.gpu
def test_scatter_drops_out_of_range_on_card(cuda):
    """``scatter_layers`` on the card with indices JAX wraps or drops (and
    a subnormal value): no device-side assert, and the CPU's sums bit for
    bit."""
    from repro_torch.core.leafmath import scatter_layers
    d, L = 8, 2
    idx = torch.tensor([[[-1, 9, 3, -9, 2**31 - 1, -8, 8, -2**31],
                         [0, 0, 5, 7, -3, 1, 2**31 - 1, 2]]] * 3,
                       dtype=torch.int32)
    vals = torch.from_numpy(np.random.default_rng(0).standard_normal(
        idx.shape).astype(np.float32))
    vals[0, 0, 2] = 1e-41
    want = scatter_layers(vals, idx, L, d)
    got = scatter_layers(vals.to(cuda), idx.to(cuda), L, d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("quarantine", [True, False])
def test_faulty_exchange_on_card(cuda, quarantine):
    """Two exchanges through the ``faulty`` wrapper around ragged perleaf
    (8-bit, the ragged CUDA codec) inside a bitflip / count / NaN burst,
    on the card against the CPU: the same rows corrupted and quarantined,
    updates and EF memory equal (as values: an unguarded NaN's payload
    may differ), the bytes, and the clean run's launches."""
    import socket

    import torch.distributed as dist
    from repro_torch.comm import faults
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4096)), "b": rng.standard_normal(
        (5000,)), "tiny": rng.standard_normal((50,))}
    tree = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}
    comp = Compressor(gamma=0.04, max_gamma=0.1, method="block_topk",
                      value_bits=8, min_compress_size=64)
    cfg = faults.FaultConfig(seed=5, p_bitflip=1.0, p_count=0.5,
                             p_nonfinite=0.3, quarantine=quarantine)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def rounds(device, transport, ctx_of):
            m = {k: 0.05 * v.to(device) for k, v in tree.items()}
            outs, counts = [], []
            for r in range(2):
                ops.reset_launch_counts()
                out = worker_compress_aggregate(
                    {k: (v * (1 + r)).to(device) for k, v in tree.items()},
                    m, np.float32(0.7), comp, gamma_t=np.float32(0.07),
                    transport=transport, transport_ctx=ctx_of(r))
                torch.cuda.synchronize()
                counts.append(ops.launch_counts())
                m = out[1]
                outs.append(out)
            return outs, counts

        def faulty(r):
            return faults.FaultCtx(cfg=cfg, step=r, inner="perleaf")
        want, _ = rounds("cpu", "faulty", faulty)
        got, counts = rounds(cuda, "faulty", faulty)
        _, clean = rounds(cuda, "perleaf", lambda r: None)
    finally:
        dist.destroy_process_group()
    assert counts == clean and all(c["unpack_words_ragged"] for c in counts)
    for g, w in zip(got, want):
        for i in (0, 1):
            for k in tree:
                np.testing.assert_array_equal(g[i][k].cpu().numpy(),
                                              w[i][k].numpy())
        assert g[2:4] == w[2:4]
        assert float(g[4].rows_quarantined) == float(w[4].rows_quarantined)
        assert (float(g[4].rows_quarantined) > 0) == quarantine
