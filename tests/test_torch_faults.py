"""The hostile-wire layer's units (``comm/faults.py``, ``wire.row_verdict``,
``wire.quarantine_rows``, ``leafmath.scatter_layers``) against the JAX
package, bit for bit.

* the host threefry draws (``fold_in``, ``split``, ``uniform``,
  ``randint``) against ``jax.random`` over a grid of seeds, lanes, steps
  and row counts;
* ``maybe_corrupt`` against JAX's word for word: each fault class and all
  four together at value bits 4, 8, 16 and 32 (ragged rows at 4 and 16
  bits and for the count fault, plain ones otherwise), the burst window
  and worker targeting (``tests/test_faults.py:61-200``), then the
  decode, verdict and quarantine of the corrupted rows;
* ``row_verdict`` / ``quarantine_rows`` and the bucketed decode with
  verdicts on ``tests/wire_fuzz.py``'s fixed-seed garbage rows and
  buckets (as ``tests/test_faults.py:338-346`` runs them), and on honest
  rows (all valid, the quarantine a no-op);
* ``scatter_layers`` at JAX's wrap-once / drop index rules and on -0.0
  sums;
* ``FaultConfig``, the scopes and the wrapper's errors word for word.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import faults as jfaults
from repro.comm import wire as jwire
from repro.comm.bucket import build_bucket_plan as jplan
from repro.comm.bucket import decode_buckets as jdecode_buckets
from repro.core import Compressor as JCompressor
from repro.core.compression import block_extract_sparse as jextract
from repro.core.leafmath import scatter_layers as jscatter
from repro_torch.comm import faults
from repro_torch.comm import wire
from repro_torch.comm.bucket import build_bucket_plan, decode_buckets
from repro_torch.comm.transport import get_transport
from repro_torch.core.compression import Compressor
from repro_torch.core.leafmath import scatter_layers

from wire_fuzz import _R, _spec

torch.set_num_threads(2)

D = 1280


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _words(x):
    """uint32 JAX words as the port's int32 tensor."""
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _port_spec(js):
    return wire.WireSpec(**dataclasses.asdict(js))


# ---------------------------------------------------------------------------
# the host draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_host_draws_equal_jax_random(seed):
    for lane, step in ((0, 0), (3, 11), (40, 2**20 + 3)):
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), lane), jnp.int32(step))
        hk = faults.fold_in(faults.fold_in(faults.prng_key(seed), lane),
                            step)
        assert [int(x) for x in np.asarray(jk)] == [int(x) for x in hk]
        jsplit = np.asarray(jax.random.split(jk, 2))
        assert [[int(a), int(b)] for a, b in faults.split(hk, 2)] == \
            jsplit.tolist()
        for R in (1, 6, 13):
            np.testing.assert_array_equal(
                np.asarray(jax.random.uniform(jk, (R, 6))).view(np.uint32),
                faults.uniform(hk, (R, 6)).view(np.uint32))
            # spans below and above 2^16 (the fold's two regimes)
            for hi in (32, 7, 131, 70_001):
                np.testing.assert_array_equal(
                    np.asarray(jax.random.randint(
                        jax.random.split(jk, 2)[1], (R,), 0, hi)),
                    faults.randint(faults.split(hk, 2)[1], (R,), 0, hi))


# ---------------------------------------------------------------------------
# the injector, then decode, verdict and quarantine of what it made
# ---------------------------------------------------------------------------

def _encoded(value_bits, adaptive, rows=6, seed=0):
    """Honest JAX (payload, spec) rows (``tests/test_faults.py``'s)."""
    comp = JCompressor(gamma=0.05, max_gamma=0.05 if adaptive else 0.0,
                       method="block_topk", block=256, min_compress_size=1,
                       value_bits=value_bits)
    spec = jwire.WireSpec.for_row(comp, D)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((rows, D)).astype(np.float32))
    vals, idx = jextract(x, comp)
    counts = None
    if spec.ragged:
        counts = jnp.asarray(rng.integers(1, spec.full_count + 1, rows),
                             jnp.int32)
    return jwire.encode_rows(vals, idx, spec, counts=counts), spec


def _both_corrupt(payload, spec, cfg, step=0, lane=0, rows_per_worker=1):
    with jfaults.active_faults(cfg, jnp.int32(step)):
        want = np.asarray(jfaults.maybe_corrupt(payload, spec, lane,
                                                rows_per_worker))
    rows = _words(payload)
    with faults.active_faults(faults.FaultConfig(**dataclasses.asdict(cfg)),
                              step):
        got = faults.maybe_corrupt(rows, _port_spec(spec), lane,
                                   rows_per_worker)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    # the input is never written
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(payload).view(np.int32))
    return want, got


@functools.lru_cache(maxsize=None)
def _jax_decode(spec):
    """JAX's decode, verdict and quarantine of rows of ``spec``, jitted
    (one compile per spec instead of an eager dispatch per operation)."""
    def fn(rows):
        v, i = jwire.decode_rows(rows, spec)
        ver = jwire.row_verdict(rows, spec, v, i)
        return (v, i, ver) + tuple(jwire.quarantine_rows(v, i, ver))
    return jax.jit(fn)


def _decode_both(want, got, spec):
    """The port's decode, verdict and quarantine of ``got`` against JAX's
    of ``want``, bit for bit; returns JAX's verdict."""
    jv, ji, jver, jqv, jqi = _jax_decode(spec)(jnp.asarray(want))
    ps = _port_spec(spec)
    tv, ti = wire.decode_rows(got, ps)
    tver = wire.row_verdict(got, ps, tv, ti)
    tqv, tqi = wire.quarantine_rows(tv, ti, tver)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tver.numpy(), np.asarray(jver))
    np.testing.assert_array_equal(_bits(tqv.numpy()), _bits(jqv))
    np.testing.assert_array_equal(tqi.numpy(), np.asarray(jqi))
    return np.asarray(jver)


CLASSES = {
    "bitflip": dict(p_bitflip=1.0),
    "count": dict(p_count=1.0),
    "nonfinite": dict(p_nonfinite=1.0),
    "zero_row": dict(p_zero_row=1.0),
    "all": dict(p_bitflip=0.5, p_count=0.5, p_nonfinite=0.5,
                p_zero_row=0.3),
}


@pytest.mark.parametrize("fault,value_bits,adaptive", [
    (f, vb, vb in (4, 16) or f == "count") for f in CLASSES
    for vb in (4, 8, 16, 32)],
    ids=lambda x: {True: "ragged", False: "plain"}.get(x, str(x)))
def test_maybe_corrupt_equals_jax(fault, value_bits, adaptive):
    payload, spec = _encoded(value_bits, adaptive)
    cfg = jfaults.FaultConfig(seed=3, **CLASSES[fault])
    for step, lane in ((5 + value_bits, 2 + adaptive),):
        want, got = _both_corrupt(payload, spec, cfg, step=step, lane=lane)
        verdict = _decode_both(want, got, spec)
        if fault == "nonfinite" or (fault == "count" and adaptive):
            assert not verdict.any()
        if fault == "zero_row":
            assert verdict.all() and not want.any()
        if fault == "count" and not adaptive:
            # no count header to corrupt: the rows pass untouched
            assert (want == np.asarray(payload)).all()


def test_burst_window_and_worker_targeting():
    # six rows, as the class cases above: their shapes are compiled
    payload, spec = _encoded(32, False)
    cfg = jfaults.FaultConfig(p_zero_row=1.0, start_step=10, n_steps=3)
    for step, hit in ((9, False), (10, True), (12, True), (13, False)):
        want, got = _both_corrupt(payload, spec, cfg, step=step)
        assert (want != np.asarray(payload)).any() == hit, step
        if not hit:
            # out of the window: the same tensor, nothing launched
            rows = _words(payload)
            with faults.active_faults(faults.FaultConfig(
                    **dataclasses.asdict(cfg)), step):
                assert faults.maybe_corrupt(rows, _port_spec(spec), 0,
                                            1) is rows
    # rows_per_worker=2: slot 1 is rows 2..3 of the gathered stack
    for tgt in (jfaults.FaultConfig(p_zero_row=1.0, worker=1),
                jfaults.FaultConfig(p_bitflip=1.0, p_nonfinite=0.5,
                                    worker=0, seed=9)):
        want, got = _both_corrupt(payload, spec, tgt, rows_per_worker=2,
                                  step=4, lane=1)
        ref = np.asarray(payload)
        quiet = np.arange(len(ref)) // 2 != tgt.worker
        assert (want[~quiet] != ref[~quiet]).any()
        np.testing.assert_array_equal(want[quiet], ref[quiet])
        _decode_both(want, got, spec)


def test_identity_without_campaign():
    rows = _words(_encoded(32, False)[0])
    spec = _port_spec(_encoded(32, False)[1])
    assert faults.maybe_corrupt(rows, spec, 0, 1) is rows
    with faults.active_faults(faults.FaultConfig(), 0):
        assert faults.maybe_corrupt(rows, spec, 0, 1) is rows


# ---------------------------------------------------------------------------
# the verdict layer on garbage: tests/wire_fuzz.py's fixed seeds
# ---------------------------------------------------------------------------

_FUZZ_GRID = [(s, 193 + 331 * s, blk, vb, adaptive, method)
              for s, (blk, vb, adaptive, method) in enumerate(
                  [(64, 4, True, "block_topk"), (256, 8, False, "topk"),
                   (1024, 16, True, "block_topk"), (256, 32, False,
                                                    "block_topk"),
                   (64, 32, True, "topk"), (256, 4, False, "topk")])]


@pytest.mark.parametrize("seed,d,block,vb,adaptive,method", _FUZZ_GRID)
def test_verdict_on_garbage_rows_equals_jax(seed, d, block, vb, adaptive,
                                            method):
    _, spec = _spec(d, block, vb, adaptive, method)
    if spec is None:
        return
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 1 << 32, (_R, spec.row_words),
                           dtype=np.uint32)
    verdict = _decode_both(payload, _words(payload), spec)
    # plus every row's own flavour of garbage: the verdicts both ways
    assert verdict.shape == (_R,)
    # honest rows: all valid, the quarantine a no-op
    comp = Compressor(gamma=0.05, max_gamma=0.05 if adaptive else 0.0,
                      method=method, block=block, min_compress_size=1,
                      value_bits=vb)
    ps = wire.WireSpec.for_row(comp, d)
    assert ps == _port_spec(spec)
    x = torch.from_numpy(rng.standard_normal((_R, d)).astype(np.float32))
    if method == "block_topk":
        from repro_torch.core.compression import block_extract_sparse
        vals, idx = block_extract_sparse(x, comp)
    else:
        from repro_torch.core.leafmath import per_layer_topk
        vals, idx = per_layer_topk(x, comp.k_for(d))
    counts = torch.from_numpy(rng.integers(1, ps.full_count + 1, _R).astype(
        np.int32)) if ps.ragged else None
    honest = wire.encode_rows(vals, idx, ps, counts=counts)
    dv, di = wire.decode_rows(honest, ps)
    ver = wire.row_verdict(honest, ps, dv, di)
    assert ver.dtype == torch.bool and bool(ver.all())
    qv, qi = wire.quarantine_rows(dv, di, ver)
    assert torch.equal(qv.view(torch.int32), dv.view(torch.int32))
    assert torch.equal(qi, di)
    _decode_both(honest.numpy().view(np.uint32), honest, spec)


@pytest.mark.parametrize("seed", range(4))
def test_verdict_on_garbage_buckets_equals_jax(seed):
    """tests/wire_fuzz.py's garbage bucket through both batched decodes
    with verdicts: values, indices and per-lane verdicts bit for bit."""
    value_bits, adaptive = [4, 8, 16, 32][seed], seed % 2
    rng = np.random.default_rng(seed)
    kw = dict(gamma=0.05, max_gamma=0.05 if adaptive else 0.0,
              method="block_topk", block=256, min_compress_size=64,
              value_bits=value_bits)
    shapes = [(2, int(rng.integers(64, 2048))),
              (int(rng.integers(64, 2048)),)]
    plan = build_bucket_plan(shapes, [True, False], Compressor(**kw))
    jp = jplan(shapes, [True, False], JCompressor(**kw))
    assert plan.total_words == jp.total_words
    if not plan.total_words:
        return
    gathered = rng.integers(0, 1 << 32, (2, plan.total_words),
                            dtype=np.uint32)
    jdec, jver = jax.jit(lambda g: jdecode_buckets(
        jp, g, with_verdicts=True))(jnp.asarray(gathered))
    tdec, tver = decode_buckets(plan, _words(gathered), with_verdicts=True)
    plain = decode_buckets(plan, _words(gathered))
    for ln in plan.leaves:
        if ln.dense:
            assert tdec[ln.index] is None and tver[ln.index] is None
            continue
        np.testing.assert_array_equal(tver[ln.index].numpy(),
                                      np.asarray(jver[ln.index]))
        np.testing.assert_array_equal(_bits(tdec[ln.index][0].numpy()),
                                      _bits(jdec[ln.index][0]))
        np.testing.assert_array_equal(tdec[ln.index][1].numpy(),
                                      np.asarray(jdec[ln.index][1]))
        # the valid rows of the guarded decode are the unguarded decode's
        ok = tver[ln.index].numpy()
        np.testing.assert_array_equal(
            _bits(tdec[ln.index][0].numpy()[ok]),
            _bits(plain[ln.index][0].numpy()[ok]))


# ---------------------------------------------------------------------------
# the scatter's index rules
# ---------------------------------------------------------------------------

def test_scatter_layers_wraps_and_drops_as_jax():
    """d = 8: -1 wraps to 7, -8 to 0; 9, 8, -9, 2^31-1 and -2^31 are
    dropped (JAX's ``.at[].add``); a dropped entry written as -0.0 at
    index 0 leaves every sum bit for bit, those of -0.0 values too."""
    d, L = 8, 2
    idx = np.array([[[-1, 9, 3, -9, 2**31 - 1, -8, 8, -2**31],
                     [0, 0, 5, 7, -3, 1, 2**31 - 1, 2]],
                    [[6, -1, -9, 3, 0, 8, 4, 4],
                     [-8, 9, 0, -0, 2, 2, -2**31, 7]]], np.int32)
    vals = np.random.default_rng(0).standard_normal(idx.shape).astype(
        np.float32)
    vals[0, 1, :2] = -0.0     # a -0.0 sum at index 0 of layer 1 ...
    vals[1, 1, 0] = -0.0
    vals[1, 1, 2:4] = -0.0
    for W in (1, 2):
        v, i = vals[:W], idx[:W]
        want = np.asarray(jax.jit(lambda a, b: jscatter(
            a, b, L, d, jnp.float32))(v, i))
        got = scatter_layers(torch.from_numpy(v), torch.from_numpy(i), L,
                             d).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # (L, k) pairs without a worker axis
        got2 = scatter_layers(torch.from_numpy(v[0]), torch.from_numpy(i[0]),
                              L, d).numpy()
        np.testing.assert_array_equal(_bits(got2), _bits(np.asarray(
            jscatter(jnp.asarray(v[0]), jnp.asarray(i[0]), L, d,
                     jnp.float32))))


# ---------------------------------------------------------------------------
# configs, scopes and the wrapper's errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(p_count=1.5), dict(p_nonfinite=-0.1),
                                dict(p_bitflip=0.1, start_step=-1),
                                dict(p_zero_row=2.0)],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_fault_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as e:
        jfaults.FaultConfig(**kw)
    with pytest.raises(ValueError) as t:
        faults.FaultConfig(**kw)
    assert str(t.value) == str(e.value)
    assert dataclasses.asdict(faults.FaultConfig()) == \
        dataclasses.asdict(jfaults.FaultConfig())
    assert not faults.FaultConfig().enabled
    assert faults.FaultConfig(p_bitflip=0.1).enabled


def test_guards_and_scopes():
    assert faults.guards_active()
    with faults.guards_disabled():
        assert not faults.guards_active()
    assert faults.guards_active()
    with faults.active_faults(faults.FaultConfig(p_bitflip=0.5), 0):
        assert faults.guards_active() and faults.injection_active()
    with faults.active_faults(
            faults.FaultConfig(p_bitflip=0.5, quarantine=False), 0):
        assert not faults.guards_active()
    with faults.active_faults(faults.FaultConfig(), 0):
        assert faults.guards_active() and not faults.injection_active()
    assert not faults.injection_active()


def test_faulty_wrapper_errors_match_jax():
    from repro.comm.transport import get_transport as jget
    t, jt = get_transport("faulty"), jget("faulty")
    assert t.stateful and jt.stateful and t.description == jt.description
    cfg = faults.FaultConfig(p_bitflip=0.5)
    jcfg = jfaults.FaultConfig(p_bitflip=0.5)
    for inner in ("faulty", "overlap", "gossip"):
        with pytest.raises(ValueError) as e:
            jt.exchange(None, None, None, None, None, ("data",), None, 1,
                        ctx=jfaults.FaultCtx(cfg=jcfg, step=0, inner=inner))
        with pytest.raises(ValueError) as p:
            t.exchange(None, None, None, None, None, None, None,
                       ctx=faults.FaultCtx(cfg=cfg, step=0, inner=inner))
        assert str(p.value) == str(e.value)
