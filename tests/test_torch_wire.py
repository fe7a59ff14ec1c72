"""The port's wire codec, bucketed exchange and byte accounting against
their JAX twins.

The same numpy inputs go through ``repro`` (the exchange in a 1-device
``shard_map``, as tests/test_bucket.py runs it; the EF ops in Pallas
interpret mode) and ``repro_torch`` (plain PyTorch versions on the CPU,
a gloo process group of one).

Tolerances: payload words, decoded values and indices, updates, EF
memory and every byte count are bit-exact.  Telemetry ratios are formed
from f32 sums over whole leaves whose reduction order differs between XLA
and PyTorch; they are held to rel 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.comm import bucket as jbucket
from repro.core import Compressor as JCompressor
from repro.core import compression as jcomp
from repro.core.dcsgd import dense_aggregate as jdense_aggregate
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro_torch.comm import bucket, exchange
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import compression
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import dense_aggregate, worker_compress_aggregate

torch.set_num_threads(2)

CASES = [
    dict(gamma=0.05, method="block_topk", block=512, min_compress_size=64,
         value_bits=8),
    dict(gamma=0.05, method="block_topk", block=512, min_compress_size=64,
         value_bits=32),
    dict(gamma=0.05, method="block_topk", block=512, min_compress_size=64,
         value_bits=4),
    dict(gamma=0.05, method="topk", min_compress_size=64, value_bits=16),
    dict(gamma=0.05, method="topk", min_compress_size=64, value_bits=32),
    dict(gamma=0.02, method="block_topk", min_compress_size=64,
         value_bits=16),
    dict(method="none"),
]


def _ids(c):
    return "-".join(f"{k}={v}" for k, v in c.items())


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((3, 2048)).astype(np.float32),
        "b": rng.standard_normal((3000,)).astype(np.float32),
        "tiny": rng.standard_normal((50,)).astype(np.float32),  # dense
        "c": rng.standard_normal((2, 4, 300)).astype(np.float32),
        "big": rng.standard_normal((70000,)).astype(np.float32),
    }


def _jax_exchange(tree, mem, eta, comp):
    from repro.compat import shard_map
    mesh = jax.make_mesh((1,), ("data",))
    spec = jax.tree.map(lambda _: P(), tree)
    f = shard_map(
        functools.partial(jwca, comp=comp, dp_axes=("data",),
                          transport="bucketed"),
        mesh=mesh, in_specs=(spec, spec, P()),
        out_specs=(spec, spec, P(), P(), P()), axis_names={"data"})
    return jax.jit(f)(tree, mem, jnp.float32(eta))


@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_worker_compress_aggregate_matches_jax(kw):
    """Updates, new EF memory and the byte count bit for bit (the JAX
    effective count equals it: no payload of the fixed schedule is
    ragged); the memory is non-zero going in, so the EF accumulation is
    exercised."""
    tree = _tree(0)
    rng = np.random.default_rng(1)
    mem = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    eta = np.float32(0.7)
    j_upd, j_mem, j_wire, j_eff, j_tel = _jax_exchange(
        tree, mem, eta, JCompressor(**kw))
    t_upd, t_mem, t_wire, t_eff, t_tel = worker_compress_aggregate(
        to_torch(tree), to_torch(mem), eta, Compressor(**kw))
    for name in tree:
        np.testing.assert_array_equal(np.asarray(j_upd[name]),
                                      t_upd[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(j_mem[name]),
                                      t_mem[name].numpy(), err_msg=name)
    assert float(j_wire) == float(t_wire)
    assert float(j_eff) == float(t_eff) == float(t_wire)
    for field in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
        np.testing.assert_allclose(float(getattr(j_tel, field)),
                                   float(getattr(t_tel, field)), rtol=1e-5,
                                   err_msg=field)


@pytest.mark.parametrize("value_bits", [4, 8, 16, 32])
def test_encode_decode_buckets_match_jax(value_bits):
    """The flat payload words and their decode, bit for bit, on rows
    with tied and zero magnitudes."""
    kw = dict(gamma=0.05, method="block_topk", block=512,
              min_compress_size=64, value_bits=value_bits)
    jc, tc = JCompressor(**kw), Compressor(**kw)
    rng = np.random.default_rng(value_bits)
    shapes, stacked = [(3, 2048), (3000,), (50,), (2, 1200)], \
        [True, False, False, True]
    xs = [np.round(rng.standard_normal(s) * 3).astype(np.float32)
          for s in shapes]
    jplan = jbucket.build_bucket_plan(shapes, stacked, jc)
    tplan = bucket.build_bucket_plan(shapes, stacked, tc)
    assert jplan.total_words == tplan.total_words
    jrows, trows = [None] * 4, [None] * 4
    for ln in tplan.leaves:
        if ln.dense:
            continue
        x2 = xs[ln.index].reshape(ln.L, -1)
        jv, ji = jcomp.block_extract_sparse(jnp.asarray(x2), jc)
        tv, ti = compression.block_extract_sparse(torch.from_numpy(x2), tc)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        jrows[ln.index], trows[ln.index] = (jv, ji, None), (tv, ti, None)
    # jitted, as the JAX trainer runs it: XLA turns the scale's division
    # by qmax into a multiplication by its reciprocal, and eager JAX
    # divides (the two differ in the last bit of some scales)
    jpay = jax.jit(lambda r: jbucket.encode_buckets(jplan, r))(jrows)
    tpay = bucket.encode_buckets(tplan, trows)
    np.testing.assert_array_equal(np.asarray(jpay),
                                  tpay.numpy().view(np.uint32))
    exchange.check_bucket_payload(tpay, tplan, tc)
    jdec = jbucket.decode_buckets(jplan, jnp.stack([jpay, jpay]))
    tdec = bucket.decode_buckets(tplan, torch.stack([tpay, tpay]))
    for a, b in zip(jdec, tdec):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy())
        np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())


@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_byte_accounting_matches_jax(kw):
    jc, tc = JCompressor(**kw), Compressor(**kw)
    shapes = [(3, 2048), (3000,), (50,), (2, 4, 300), (70000,),
              (12, 768, 768), (16384, 768)]
    for s in shapes:
        assert jc.leaf_wire_bytes(s) == tc.leaf_wire_bytes(s), s
        # the fixed schedule ships whole payload rows: JAX's per-round
        # effective bytes are the port's wire bytes
        assert float(jcomp.leaf_effective_wire_bytes(
            jc, s, jnp.float32(jc.gamma))) == tc.leaf_wire_bytes(s), s
    for d in (50, 999, 1000, 2048, 3000, 70000, 589824):
        assert jc.sparse_k(d) == tc.sparse_k(d)
        assert jc.ships_dense(d) == tc.ships_dense(d)


def test_check_bucket_payload_rejects_drift():
    tc = Compressor(gamma=0.05, method="block_topk", block=512,
                    min_compress_size=64)
    plan = bucket.build_bucket_plan([(3, 2048)], [True], tc)
    good = torch.zeros(plan.total_words, dtype=torch.int32)
    exchange.check_bucket_payload(good, plan, tc)
    with pytest.raises(ValueError, match="int32"):
        exchange.check_bucket_payload(good.float(), plan, tc)
    with pytest.raises(ValueError, match="plan says"):
        exchange.check_bucket_payload(good[1:], plan, tc)


def test_dense_aggregate_matches_jax():
    from repro.compat import shard_map
    tree = _tree(5)
    mesh = jax.make_mesh((1,), ("data",))
    spec = jax.tree.map(lambda _: P(), tree)
    j_upd, j_wire = jax.jit(shard_map(
        lambda g: jdense_aggregate(g, jnp.float32(0.1), ("data",)),
        mesh=mesh, in_specs=(spec,), out_specs=(spec, P()),
        axis_names={"data"}))(tree)
    t_upd, t_wire = dense_aggregate(to_torch(tree), np.float32(0.1))
    for k, v in to_numpy(t_upd).items():
        np.testing.assert_array_equal(np.asarray(j_upd[k]), v, err_msg=k)
    assert float(j_wire) == float(t_wire)
