"""The federated cohort's building blocks against the JAX package
(``src/repro/fed``, DESIGN.md §13).

* ``participation_mask``: both samplers, stragglers, seeds and rounds on
  fixed inputs, bit for bit, and JAX's errors word for word;
* ``scatter_with_support`` / ``aggregate_decoded`` in both modes on rows
  with out-of-range indices, subnormal values and zeros, and on
  ``tests/wire_fuzz.py``'s garbage buckets decoded guarded and
  unguarded (the support taken after JAX's index rules); ``support`` ==
  ``mean`` bit for bit where every participant sends every coordinate;
* ``cohort_compress_aggregate`` at one device against jitted JAX with
  ``dp_axes=None``, crossing ``topk`` / ``block_topk``, 32 / 8 bits, the
  fixed budget / per-client ragged gamma and ``support`` / ``mean`` under
  a mask with a non-participant, plus three fault campaigns under
  ``active_faults`` (tests/torch_fed_workers.py's ``CASES``): ONE jitted
  program over all cases;
* the same on 2 gloo workers against JAX's exchange under
  ``jax.jit(jax.vmap(f, axis_name="data"))``;
* the NumPy oracle ``tests/federated/reference.py`` against the port;
* the golden non-IID pair of ``tests/federated/test_golden_noniid.py``
  in the port with its asserted ranges, and JAX's trajectory equal over
  its first rounds.

Tolerances: masks, payload bytes, byte counts, quarantined rows, the
compressed leaves' updates and every client's EF memory bit for bit (a
non-finite entry of an unguarded round equal as a value, NaN to NaN);
the dense leaves' updates within 8 ulp (DESIGN.md §11).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm import faults as jfaults
from repro.comm.bucket import build_bucket_plan as jplan
from repro.comm.bucket import decode_buckets as jdecode_buckets
from repro.core import Compressor as JCompressor
from repro.fed import aggregate as jagg
from repro.fed.clients import cohort_compress_aggregate as jcohort
from repro.fed.sampling import participation_mask as jmask
from repro_torch.comm import exchange
from repro_torch.comm.bucket import build_bucket_plan, decode_buckets
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.fed import aggregate as tagg
from repro_torch.fed import (ZeroParticipationError, cohort_compress_aggregate,
                             participation_mask, per_client_wire_bytes)

import torch_fed_workers as fw
import torch_overlap_workers as ow
from federated.reference import simulate_cohort

torch.set_num_threads(2)

f32 = np.float32
NAMES, SMASK = fw.NAMES, fw.SMASK


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same(want, got, where, exact=True):
    """Bit for bit, or equal as values (NaN to NaN) when not ``exact``."""
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


# ---------------------------------------------------------------------------
# participation masks
# ---------------------------------------------------------------------------

_MASKS = [dict(mode="fixed", clients_per_round=k) for k in (0, 1, 5, 16)] \
    + [dict(mode="bernoulli", rate=r) for r in (0.3, 0.9, 1.0)] \
    + [dict(mode="fixed", clients_per_round=12, straggler_rate=0.4),
       dict(mode="bernoulli", rate=0.8, straggler_rate=0.25)]


@pytest.mark.parametrize("kw", _MASKS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_participation_masks_equal_jax(kw):
    for seed, rnd in ((0, 0), (0, 7), (3, 1), (11, 123)):
        want = jmask(16, rnd, seed=seed, **kw)
        got = participation_mask(16, rnd, seed=seed, **kw)
        assert got.dtype == np.float32 and got.shape == (16,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args,kw", [
    ((4, 0), dict(mode="ring")), ((0, 0), {}), ((-1, 0), {}),
    ((4, 0), dict(clients_per_round=5)), ((4, 0), dict(clients_per_round=-1)),
    ((4, 0), dict(mode="bernoulli", rate=1.5)),
    ((4, 0), dict(mode="bernoulli", rate=-0.1)),
    ((4, 0), dict(straggler_rate=1.0)), ((4, 0), dict(straggler_rate=-0.2)),
    ((4, 0), dict(mode="bernoulli", rate=0.0)),
    ((1, 2), dict(straggler_rate=0.99))],
    ids=lambda x: "-".join(f"{v}" for v in x.values())
    if isinstance(x, dict) else str(x))
def test_participation_errors_match_jax(args, kw):
    with pytest.raises(ValueError) as e:
        jmask(*args, **kw)
    with pytest.raises(ValueError) as t:
        participation_mask(*args, **kw)
    assert str(t.value) == str(e.value)
    assert isinstance(t.value, ZeroParticipationError) == \
        (type(e.value).__name__ == "ZeroParticipationError")


# ---------------------------------------------------------------------------
# the aggregate
# ---------------------------------------------------------------------------

def _decoded_rows(seed, N=5, L=2, k=12, d=40):
    """(N, L, k) decoded-like rows: zeros, duplicates, subnormals, and
    indices that wrap ([-d, 0)) or are dropped (>= d, < -d)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((N, L, k)).astype(f32)
    vals[rng.random(vals.shape) < 0.2] = 0.0
    vals[0, 0, :2] = np.float32(1e-40)                   # subnormal
    idx = rng.integers(0, d, (N, L, k)).astype(np.int32)
    idx[1, 0, :3] = [-1, d, -d - 1]
    idx[2, 1, :2] = [2**31 - 1, -d]
    return vals, idx, d


@pytest.mark.parametrize("agg", ["support", "mean"])
def test_aggregate_matches_jax(agg):
    N, L = 5, 2
    w = np.array([1, 0, 1, 1, 0], f32)
    for seed in range(3):
        vals, idx, d = _decoded_rows(seed, N, L)
        n = np.float32(w.sum())
        jt, js = jax.jit(lambda v, i, ww: jagg.scatter_with_support(
            v, i, ww, L, d))(vals, idx, w)
        tt, ts = tagg.scatter_with_support(
            torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(w), L, d)
        _same(np.asarray(jt), tt.numpy(), f"total seed {seed}")
        _same(np.asarray(js), ts.numpy(), f"support seed {seed}")
        want = jax.jit(lambda v, i, ww, nn: jagg.aggregate_decoded(
            v, i, ww, L, d, nn, agg))(vals, idx, w, n)
        got = tagg.aggregate_decoded(
            torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(w), L, d, torch.tensor(n), agg)
        _same(np.asarray(want), got.numpy(), f"{agg} seed {seed}")


def test_support_equals_mean_when_every_participant_sends_everything():
    """Every participant sends every coordinate, nonzero: the two modes
    are the same division, bit for bit, in both packages."""
    rng = np.random.default_rng(4)
    N, L, d = 4, 3, 64
    vals = rng.standard_normal((N, L, d)).astype(f32)
    idx = np.broadcast_to(np.arange(d, dtype=np.int32), (N, L, d)).copy()
    for i in range(N):                     # each row in its own order
        perm = rng.permutation(d)
        vals[i], idx[i] = vals[i][:, perm], idx[i][:, perm]
    w = np.array([1, 1, 0, 1], f32)
    n = torch.tensor(np.float32(3.0))
    t = [tagg.aggregate_decoded(torch.from_numpy(vals),
                                torch.from_numpy(idx), torch.from_numpy(w),
                                L, d, n, a).numpy() for a in ("support",
                                                              "mean")]
    j = [np.asarray(jagg.aggregate_decoded(vals, idx, w, L, d,
                                           jnp.float32(3.0), a))
         for a in ("support", "mean")]
    _same(t[0], t[1], "port support vs mean")
    _same(j[0], t[0], "support vs JAX")
    _same(j[1], t[1], "mean vs JAX")


@pytest.mark.parametrize("seed", range(4))
def test_aggregate_on_garbage_buckets_matches_jax(seed):
    """tests/wire_fuzz.py's garbage bucket (4 gathered client rows)
    decoded with and without the verdicts, then aggregated both ways
    (one jitted JAX program a seed): unguarded, its out-of-range indices
    must not count as support."""
    value_bits, adaptive = [4, 8, 16, 32][seed], seed % 2
    rng = np.random.default_rng(seed)
    kw = dict(gamma=0.05, max_gamma=0.05 if adaptive else 0.0,
              method="block_topk", block=256, min_compress_size=64,
              value_bits=value_bits)
    shapes = [(2, int(rng.integers(64, 2048))),
              (int(rng.integers(64, 2048)),)]
    plan = build_bucket_plan(shapes, [True, False], Compressor(**kw))
    jp = jplan(shapes, [True, False], JCompressor(**kw))
    gathered = rng.integers(0, 1 << 32, (4, plan.total_words),
                            dtype=np.uint32)
    w = np.array([1, 1, 0, 1], f32)
    lanes = [ln for ln in plan.leaves if not ln.dense]

    def outputs(decode, aggregate, support):
        """{(guarded, leaf, what): (L, d)} through one package."""
        out = {}
        for guarded in (True, False):
            dec = decode(guarded)
            for ln in lanes:
                v, i = dec[ln.index]
                for agg in ("support", "mean"):
                    out[guarded, ln.index, agg] = aggregate(v, i, ln, agg)
                out[guarded, ln.index, "count"] = support(v, i, ln)
        return out

    def jdecode(g):
        return lambda guarded: (jdecode_buckets(jp, g, with_verdicts=True)[0]
                                if guarded else jdecode_buckets(jp, g))
    # the count a traced input, as the cohort's is: jitted XLA folds a
    # division by a constant into a product with its reciprocal
    want = jax.jit(lambda g, ww, n: outputs(
        jdecode(g),
        lambda v, i, ln, agg: jagg.aggregate_decoded(v, i, ww, ln.L, ln.d,
                                                     n, agg),
        lambda v, i, ln: jagg.scatter_with_support(v, i, ww, ln.L,
                                                   ln.d)[1]))(
        jnp.asarray(gathered), w, jnp.float32(3.0))
    words = torch.from_numpy(gathered.view(np.int32).copy())
    tw, tn = torch.from_numpy(w), torch.tensor(f32(3.0))
    got = outputs(
        lambda guarded: (decode_buckets(plan, words, with_verdicts=True)[0]
                         if guarded else decode_buckets(plan, words)),
        lambda v, i, ln, agg: tagg.aggregate_decoded(v, i, tw, ln.L, ln.d,
                                                     tn, agg),
        lambda v, i, ln: tagg.scatter_with_support(v, i, tw, ln.L,
                                                   ln.d)[1])
    for key, t in got.items():
        _same(np.asarray(want[key]), t.numpy(), f"{key}",
              exact=key[0] or key[2] == "count")


# ---------------------------------------------------------------------------
# the cohort exchange: one device, then two gloo workers
# ---------------------------------------------------------------------------

def _jax_case(name, dp_axes):
    kw, agg, fkw = fw.CASES[name]
    comp = JCompressor(**kw)

    def f(g, m, e, gc, mask):
        if fkw:
            with jfaults.active_faults(jfaults.FaultConfig(**fkw), fw.STEP):
                return jcohort(g, m, e, comp, dp_axes, mask, gc,
                               stacked_mask=SMASK, aggregation=agg,
                               return_quarantined=True)
        return jcohort(g, m, e, comp, dp_axes, mask, gc,
                       stacked_mask=SMASK, aggregation=agg,
                       return_quarantined=True)
    return f


def _inputs(name):
    """The case's inputs and the mask, a traced input as the trainer's
    batch makes it (a constant mask would let XLA fold the divisions by
    the participant count into products)."""
    return fw.cohort_inputs(name) + (fw.MASK,)


@functools.lru_cache(maxsize=None)
def _jax_one_device():
    """Every case through JAX at ``dp_axes=None``, one jitted program:
    {name: (updates, memory, wire, eff, quarantined)} as NumPy."""
    fns = {name: _jax_case(name, None) for name in fw.CASES}
    out = jax.jit(lambda ins: {n: fns[n](*ins[n]) for n in fw.CASES})(
        {n: _inputs(n) for n in fw.CASES})
    return jax.tree.map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _jax_two_workers():
    """Every case through JAX's exchange on 2 workers, vmapped over
    ``"data"`` (each worker's 2 clients), one jitted program."""
    W, C = 2, fw.N_CLIENTS // 2
    fns = {name: jax.vmap(_jax_case(name, "data"), axis_name="data",
                          in_axes=(0, 0, 0, 0, None))
           for name in fw.CASES}

    def split(x):
        return x.reshape((W, C) + x.shape[1:])
    ins = {n: jax.tree.map(split, _inputs(n)[:4]) + (fw.MASK,)
           for n in fw.CASES}
    out = jax.jit(lambda i: {n: fns[n](*i[n]) for n in fw.CASES})(ins)
    return jax.tree.map(np.asarray, out)


def _dense_names(name):
    plan = build_bucket_plan(fw.SHAPES, fw.STACKED,
                             Compressor(**fw.CASES[name][0]))
    return {NAMES[i] for i in plan.dense_ids}


def _check(name, want, got, where):
    """``got`` (a port_case result) against JAX's ``want`` = (updates,
    memory over the same clients, wire, eff, quarantined)."""
    exact = fw.CASES[name][2] is None or \
        fw.CASES[name][2].get("quarantine", True)
    dense = _dense_names(name)
    for n in NAMES:
        w_u, g_u = want[0][n], got[0][n]
        if n in dense:
            np.testing.assert_array_max_ulp(g_u, w_u, maxulp=8)
        else:
            _same(w_u, g_u, f"{where} update {n}", exact)
        _same(want[1][n], got[1][n], f"{where} memory {n}", exact)
    assert (got[2], got[3], got[4]) == (float(want[2]), float(want[3]),
                                        float(want[4])), where


@pytest.mark.parametrize("name", list(fw.CASES))
def test_cohort_one_device_matches_jax(name):
    want = _jax_one_device()[name]
    got = fw.port_case(name, slice(None), None)
    _check(name, want, got, name)
    kw, _, fkw = fw.CASES[name]
    plan = build_bucket_plan(fw.SHAPES, fw.STACKED, Compressor(**kw))
    assert got[2] == 3.0 * per_client_wire_bytes(plan)
    if fkw and fkw.get("quarantine", True):
        assert got[4] > 0
    if fkw is None:
        assert got[4] == 0.0
        # the non-participant's memory stays as it was, bit for bit
        m = _inputs(name)[1]
        for n in NAMES:
            _same(m[n][3], got[1][n][3], f"{name} client 3 {n}")


@pytest.fixture(scope="module")
def two():
    """2 gloo workers, started at once and left to run while the JAX
    references compile; forked from one server that imports torch once."""
    return ow.Spawned(fw.cohort_exchanges, 2,
                      preload=("torch_overlap_workers", "torch_fed_workers"))


@pytest.mark.parametrize("name", list(fw.CASES))
def test_cohort_two_workers_match_jax(name, two):
    want = _jax_two_workers()[name]
    got = two.result()
    for r in range(2):
        w_r = (jax.tree.map(lambda x: x[r], want[0]),
               jax.tree.map(lambda x: x[r], want[1]),
               want[2][r], want[3][r], want[4][r])
        _check(name, w_r, got[r][name], f"{name} rank {r}")
    # one device and two workers: the same updates and memories
    one = _jax_one_device()[name]
    for n in NAMES:
        if n not in _dense_names(name):
            _same(one[0][n], want[0][n][0], f"{name} {n} W=1 vs W=2",
                  fw.CASES[name][2] is None)


# ---------------------------------------------------------------------------
# the NumPy oracle and the golden non-IID pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["support", "mean"])
def test_numpy_oracle(agg):
    """tests/federated/reference.py (float64, topk at 32 bits, ragged
    per-client gamma) against the port, at the JAX parity suite's
    tolerances."""
    kw = dict(gamma=0.02, method="topk", min_compress_size=1000,
              value_bits=32, max_gamma=0.2)
    rng = np.random.default_rng(0)
    N = 16
    grads = {"w": rng.standard_normal((N, 3, 1200)).astype(f32),
             "v": rng.standard_normal((N, 4096)).astype(f32),
             "t": rng.standard_normal((N, 60)).astype(f32)}
    mem = {k: (0.1 * rng.standard_normal(v.shape)).astype(f32)
           for k, v in grads.items()}
    eta = np.linspace(0.1, 0.5, N, dtype=f32)
    gamma = np.linspace(0.02, 0.2, N, dtype=f32)
    part = participation_mask(N, 3, seed=11, mode="fixed",
                              clients_per_round=12)
    upd, new_mem, wire, eff = cohort_compress_aggregate(
        to_torch(grads), to_torch(mem), eta, Compressor(**kw), None, part,
        gamma, aggregation=agg)
    ref_upd, ref_mem = simulate_cohort(grads, mem, eta, gamma, part,
                                       JCompressor(**kw, use_kernel=False),
                                       agg)
    for k in grads:
        np.testing.assert_allclose(upd[k].numpy().astype(np.float64),
                                   ref_upd[k], rtol=2e-6, atol=2e-6,
                                   err_msg=k)
        np.testing.assert_allclose(new_mem[k].numpy(), ref_mem[k], rtol=0,
                                   atol=5e-7, err_msg=k)
    # heterogeneous k_t: ragged effective bytes strictly below budget
    assert 0.0 < float(eff) < float(wire)


GOLD_D, GOLD_N, GOLD_STRIPE, GOLD_ROUNDS = 2048, 64, 32, 40
GOLD_ETA, GOLD_GAMMA, GOLD_CHECKED = 0.3, 0.05, 4


def _golden_grads(w, wstar, noniid):
    resid = w - wstar
    if not noniid:
        return np.broadcast_to(resid, (GOLD_N, GOLD_D)).copy()
    g = np.zeros((GOLD_N, GOLD_D), f32)
    for c in range(GOLD_N):
        sl = slice(c * GOLD_STRIPE, (c + 1) * GOLD_STRIPE)
        g[c, sl] = resid[sl]
    return g


def _golden(noniid, agg, rounds, jax_side=False):
    """tests/federated/test_golden_noniid.py's loop through one package:
    the relative error after ``rounds`` and the iterate after each."""
    kw = dict(gamma=GOLD_GAMMA, method="topk", min_compress_size=64,
              value_bits=32)
    rng = np.random.default_rng(0)
    wstar = rng.standard_normal(GOLD_D).astype(f32)
    w = np.zeros(GOLD_D, f32)
    if jax_side:
        comp = JCompressor(**kw, use_kernel=False)
        mem = jnp.zeros((GOLD_N, GOLD_D), jnp.float32)
        step = jax.jit(lambda g, m, p: tuple(
            x["w"] for x in jcohort({"w": g}, {"w": m},
                                    jnp.float32(GOLD_ETA), comp, None, p,
                                    aggregation=agg)[:2]))
    else:
        comp = Compressor(**kw)
        mem = torch.zeros((GOLD_N, GOLD_D))

        def step(g, m, p):
            u, nm, _, _ = cohort_compress_aggregate(
                {"w": torch.from_numpy(g)}, {"w": m}, f32(GOLD_ETA), comp,
                None, p, aggregation=agg)
            return u["w"].numpy(), nm["w"]
    path = []
    for t in range(rounds):
        mask = participation_mask(GOLD_N, t, seed=5, mode="fixed",
                                  clients_per_round=48)
        u, mem = step(_golden_grads(w, wstar, noniid), mem, mask)
        w = w - np.asarray(u)
        path.append(w.copy())
    return float(np.mean((w - wstar) ** 2) / np.mean(wstar ** 2)), path


@pytest.mark.parametrize("noniid,agg", [(False, "support"),
                                        (True, "support"), (True, "mean")])
def test_golden_noniid_first_rounds_equal_jax(noniid, agg):
    """The pair's three runs, their first rounds through both packages:
    the iterate after each round bit for bit."""
    _, want = _golden(noniid, agg, GOLD_CHECKED, jax_side=True)
    _, got = _golden(noniid, agg, GOLD_CHECKED)
    for t, (a, b) in enumerate(zip(want, got)):
        _same(a, b, f"round {t}")


def test_golden_noniid_convergence_pair():
    """tests/federated/test_golden_noniid.py's ranges, on the port."""
    iid = _golden(False, "support", GOLD_ROUNDS)[0]
    sup = _golden(True, "support", GOLD_ROUNDS)[0]
    mean = _golden(True, "mean", GOLD_ROUNDS)[0]
    assert 0.005 < iid < 0.08, iid
    assert sup <= 1.05 * iid + 1e-3, (sup, iid)
    assert sup < 1e-5, sup
    assert mean > 10.0 * iid, (mean, iid)
    assert 0.5 < mean < 0.8, mean
