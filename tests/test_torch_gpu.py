"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.  Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports no JAX, so on the GPU machine it runs as

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bit-exact (tau NaN where the plain version gives NaN),
except the pass-1 moments (8 ulp: the kernel sums in f64 and rounds once,
the plain version sums in f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ef_topk, ref, wire_pack


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


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_dense_selection_kernels_match_plain_on_card(cuda, ties):
    m, x = (torch.from_numpy(v).to(cuda)
            for v in _leaves(12, (300, 1024), ties))
    eta = torch.tensor([0.37], device=cuda)
    tau = ef_topk.block_stats(x, 10)
    torch.testing.assert_close(tau, ref.block_abs_topk_threshold(x, 10),
                               rtol=0, atol=0)
    torch.testing.assert_close(ef_topk.ef_block_stats(m, x, eta, 10),
                               ref.ef_block_stats(m, x, eta, 10),
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


@pytest.mark.gpu
@pytest.mark.parametrize("k_b", [1, 10, 1024])
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
