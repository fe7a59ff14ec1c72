"""The gossip transport (``comm/topology.py``, ``comm/gossip.py``) against
the JAX package.

* ``build_topology`` for ring, torus and exp at n = 1-16: perms, degree,
  neighbours, the mixing matrix and its spectral gap equal to JAX's, and
  the error texts word for word; ``GossipConfig``'s defaults and checks;
* the exchange on 1-4 gloo workers against JAX's
  ``worker_compress_aggregate(transport="gossip")`` under
  ``jax.jit(jax.vmap(..., axis_name="data"))`` — one CPU device, whose
  ``ppermute`` batching rule equals a W-device ``shard_map`` bit for bit
  — fed the same NumPy inputs, two rounds each (JAX decodes with its
  fault verdicts on, its default): EF memory, wire and effective bytes,
  the own payload, the decoded own rows and the updates bit for bit,
  the rows each worker received equal to its neighbours' own, telemetry
  and ``v`` within 8 ulp (f32 sums over whole leaves, whose reduction
  order XLA and torch choose differently), ``lr`` bit for bit where it
  saturates at ``lr_max`` and within 8 ulp below it;
* the rounding rules the exchange follows, each pinned on jitted JAX;
* JAX's golden claim (tests/distributed/test_gossip_exchange.py:150-227):
  K = 5 steps on 4 gloo workers track a float64 mixing-matrix
  simulation, for ring and exp;
* ``gossip_mix`` on 4 workers: monotone contraction, agreement with
  ``mix_reference`` and with JAX's vmapped ``gossip_mix``, and a
  constant tree as a bit-exact fixed point.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm import gossip as jgs
from repro.comm import topology as jtopo
from repro.comm.bucket import build_bucket_plan as jplan
from repro.comm.bucket import decode_buckets as jdecode
from repro.comm.bucket import encode_buckets as jencode
from repro.core import Compressor as JCompressor
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.leafmath import select_and_encode as jselect
from repro_torch.comm import exchange
from repro_torch.comm import gossip as gs
from repro_torch.comm import topology as topo
from repro_torch.comm.bucket import build_bucket_plan, decode_buckets
from repro_torch.core.compression import Compressor

import torch_gossip_workers as gw
import torch_overlap_workers as ow

torch.set_num_threads(2)

f32 = np.float32
NAMES, SHAPES, STACKED = gw.NAMES, gw.SHAPES, gw.STACKED


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# topologies and the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ring", "torus", "exp"])
def test_topologies_match_jax(name):
    for n in range(1, 17):
        t, j = topo.build_topology(name, n), jtopo.build_topology(name, n)
        assert (t.name, t.n, t.perms, t.degree) == \
            (j.name, j.n, j.perms, j.degree), (name, n)
        assert t.mix_weight == j.mix_weight
        for i in range(n):
            assert t.neighbors(i) == j.neighbors(i)
            peers = gs.neighbour_peers(t, i)
            assert [s for _, s in peers] == list(t.neighbors(i))
        np.testing.assert_array_equal(t.mixing_matrix(), j.mixing_matrix())
        assert t.spectral_gap() == j.spectral_gap()
        assert n == 1 or t.spectral_gap() > 0
        z = np.random.default_rng(n).standard_normal((n, 5)).astype(f32)
        np.testing.assert_array_equal(t.mix_reference(z),
                                      j.mix_reference(z))
        np.testing.assert_array_equal(
            t.mix_reference(torch.from_numpy(z)).numpy(),
            t.mix_reference(z))
    assert sorted(topo.TOPOLOGIES) == sorted(jtopo.TOPOLOGIES)


def _same_error(fn, *args):
    with pytest.raises(ValueError) as e:
        getattr(jtopo, fn)(*args)
    with pytest.raises(ValueError) as t:
        getattr(topo, fn)(*args)
    assert str(t.value) == str(e.value)


def test_topology_errors_match_jax():
    _same_error("build_topology", "star", 4)
    for name in ("ring", "torus", "exp"):
        _same_error("build_topology", name, 0)
    bad = topo.Topology("bad", 3, (((0, 1), (1, 1), (2, 0)),))
    jbad = jtopo.Topology("bad", 3, (((0, 1), (1, 1), (2, 0)),))
    with pytest.raises(ValueError) as e:
        jtopo._checked(jbad)
    with pytest.raises(ValueError) as t:
        topo._checked(bad)
    assert str(t.value) == str(e.value)
    one_way = (tuple((i, (i + 1) % 3) for i in range(3)),)
    with pytest.raises(ValueError) as e:
        jtopo._checked(jtopo.Topology("dir", 3, one_way))
    with pytest.raises(ValueError) as t:
        topo._checked(topo.Topology("dir", 3, one_way))
    assert str(t.value) == str(e.value) and "symmetric" in str(t.value)


@pytest.mark.parametrize("kw", [dict(topology="star"), dict(beta=1.0),
                                dict(beta=-0.1), dict(consensus_lr=0.0),
                                dict(eps=-1.0), dict(lr_max=0.0)],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_gossip_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as e:
        jgs.GossipConfig(**kw)
    with pytest.raises(ValueError) as t:
        gs.GossipConfig(**kw)
    assert str(t.value) == str(e.value)
    assert dataclasses.asdict(gs.GossipConfig()) == \
        dataclasses.asdict(jgs.GossipConfig())


def test_state_and_exchange_errors():
    st = gs.GossipState.init()
    assert st.v.dtype == torch.float32 and st.v.shape == () and \
        float(st.v) == float(st.lr) == 0.0
    # a topology of another size, word for word
    comp = Compressor(gamma=0.05, method="block_topk")
    g = ow.exchange_inputs(1)
    ctx = gs.GossipCtx(topo.build_topology("ring", 3), gs.GossipConfig(),
                       st)
    with pytest.raises(ValueError, match="topology 'ring' is built for 3 "
                       "workers but the dp axis has 1"):
        gs.gossip_exchange([torch.from_numpy(v) for v in g.values()],
                           [torch.from_numpy(v) for v in g.values()],
                           STACKED, torch.tensor([0.1]), comp, None, None,
                           ctx=ctx)


# ---------------------------------------------------------------------------
# the rounding rules, pinned on jitted JAX
# ---------------------------------------------------------------------------

def test_rounding_rules_follow_jitted_jax():
    """What ``comm/gossip.py`` assumes of jitted XLA on the CPU: the dense
    mix's division by a constant is a product with the reciprocal, the
    sparse mix's division by a traced count a true one, ``x / n_tot`` a
    product, ``beta*v + (1-beta)*x`` and ``own + lr*e`` fused
    multiply-adds — and the port's helpers compute each the same."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20000)).astype(f32)
    dense = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0) / 3)(x))
    sparse = np.asarray(jax.jit(lambda a, c: a[0] / jnp.maximum(c, 1.0))(
        x, jnp.float32(3.0)))
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(
        _bits(dense), _bits((tx[0] + tx[1] + tx[2]) * float(f32(1) / f32(3))))
    assert (_bits(dense) != _bits((x[0] + x[1] + x[2]) / f32(3))).any()
    np.testing.assert_array_equal(_bits(sparse), _bits(gs.valid_row_mean(
        tx[0][None], torch.ones((3, 1), dtype=torch.bool))[0][0]))
    assert (_bits(sparse) != _bits(x[0] * (f32(1) / f32(3)))).any()
    # the AdaGossip step on 20,000 (v, err_sq) pairs at once
    cfg = gs.GossipConfig(consensus_lr=0.03, lr_max=0.7, beta=0.5)
    jcfg = jgs.GossipConfig(consensus_lr=0.03, lr_max=0.7, beta=0.5)
    v0 = np.abs(x[0]) * f32(1e-3)
    err = np.abs(x[1]) * f32(7.0)
    n_tot = 12345

    def jstep(v, e):
        v_new = jcfg.beta * v + (1.0 - jcfg.beta) * (e / float(n_tot))
        return v_new, jnp.minimum(jnp.float32(jcfg.lr_max),
                                  jcfg.consensus_lr / (jnp.sqrt(v_new)
                                                       + jcfg.eps))
    jv, jl = jax.jit(jstep)(v0, err)
    st = gs.adagossip_step(cfg, gs.GossipState(torch.from_numpy(v0), None),
                           torch.from_numpy(err), n_tot)
    np.testing.assert_array_equal(_bits(jv), _bits(st.v.numpy()))
    np.testing.assert_array_equal(_bits(jl), _bits(st.lr.numpy()))
    assert (st.lr < 0.7).any() and (st.lr == f32(0.7)).any()
    own, e, lr = x[0], x[1], np.abs(x[2])
    ju = np.asarray(jax.jit(lambda o, e, l: o + l * e)(own, e, lr))
    np.testing.assert_array_equal(_bits(ju), _bits(torch.addcmul(
        tx[0], torch.from_numpy(lr), tx[1]).numpy()))


# ---------------------------------------------------------------------------
# the exchange against JAX's, vmapped over W
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fn(topo_name, W, case):
    """JAX's gossip exchange of ``case`` on W workers as one jitted vmap
    over the ``data`` axis, plus each worker's own bucket payload and its
    decode: ``(g, m, eta, gamma_t, v, lr) -> (updates, memory, wire, eff,
    telemetry, state, payload, own decoded)``."""
    kw, adaptive, cfg_kw = gw.CASES[case]
    comp = JCompressor(**kw)
    t = jtopo.build_topology(topo_name, W)
    cfg = jgs.GossipConfig(topology=topo_name, **cfg_kw)
    smask = dict(zip(NAMES, STACKED))

    def worker(g, m, eta, gt, v, lr):
        out = jwca(g, m, eta, comp, ("data",), stacked_mask=smask,
                   gamma_t=gt if adaptive else None, transport="gossip",
                   transport_ctx=jgs.GossipCtx(t, cfg,
                                               jgs.GossipState(v=v, lr=lr)))
        flat_g = [g[n] for n in NAMES]
        flat_m = [m[n] for n in NAMES]
        plan = jplan(SHAPES, STACKED, comp)
        sel = jselect(flat_g, flat_m, STACKED, eta, comp,
                      gt if adaptive else None, plan)
        payload = jencode(plan, sel.enc_rows)
        return out, payload, jdecode(plan, payload[None])

    return jax.jit(jax.vmap(worker, axis_name="data"))


EPS = float(np.finfo(np.float32).eps)


def assert_upd_close(a, b, lr, where):
    """Updates whose consensus steps lr differ by a few ulp: within
    8 eps * max|update| of the leaf (|e| <= |update| + |own| keeps the
    bound loose by a factor lr)."""
    err = float(np.abs(a - b).max())
    assert err <= 8 * EPS * float(np.abs(a).max()), (where, err, lr)


def _stack(trees):
    return {n: jnp.asarray(np.stack([t[n] for t in trees])) for n in NAMES}


@functools.lru_cache(maxsize=None)
def _jax_rounds(topo_name, W, case):
    """``gw.ROUNDS`` rounds of JAX's exchange on W workers, each from the
    previous round's EF memory and state; per round a list of W dicts
    shaped like the port workers' results."""
    fn = _jax_fn(topo_name, W, case)
    idx = list(gw.CASES).index(case)
    gts = np.array([gw.case_gamma(case, r, W) or 0.0 for r in range(W)],
                   f32)
    mem = v = lr = None
    rounds = []
    for rnd in range(gw.ROUNDS):
        ins = [gw.round_inputs(idx, r, rnd) for r in range(W)]
        if mem is None:
            mem = _stack([m for _, m in ins])
            v = lr = jnp.zeros((W,), jnp.float32)
        (upd, mem, wire, eff, tel, st), payload, dec = fn(
            _stack([g for g, _ in ins]), mem,
            jnp.full((W,), gw.ETA, jnp.float32), jnp.asarray(gts), v, lr)
        mem = {n: jnp.asarray(np.asarray(x)) for n, x in mem.items()}
        v, lr = jnp.asarray(np.asarray(st.v)), jnp.asarray(np.asarray(st.lr))
        rounds.append([dict(
            upd={n: np.asarray(upd[n][r]) for n in NAMES},
            mem={n: np.asarray(mem[n][r]) for n in NAMES},
            wire=float(wire[r]), eff=float(eff[r]),
            tel=[float(getattr(tel, f)[r]) for f in gw.TEL],
            v=np.asarray(v[r]), lr=np.asarray(lr[r]),
            payload=np.asarray(payload[r]).view(np.int32),
            dec=[None if d is None else
                 (np.asarray(d[0][r, 0]), np.asarray(d[1][r, 0]))
                 for d in dec]) for r in range(W)])
    return rounds


def _check_case(topo_name, W, case, got):
    """Hold the port workers' rounds (``got[rank]``) against JAX's."""
    kw, _, cfg_kw = gw.CASES[case]
    t = topo.build_topology(topo_name, W)
    plan = build_bucket_plan(SHAPES, STACKED, Compressor(**kw))
    tw = plan.total_words
    lr_max = f32(gs.GossipConfig(**cfg_kw).lr_max)
    for rnd, jrows in enumerate(_jax_rounds(topo_name, W, case)):
        for rank in range(W):
            p, j = got[rank][rnd], jrows[rank]
            where = f"{topo_name}({W}) {case} round {rnd} rank {rank}"
            assert (p["wire"], p["eff"]) == (j["wire"], j["eff"]), where
            np.testing.assert_array_max_ulp(np.float32(j["tel"][:3]),
                                            np.float32(p["tel"][:3]),
                                            maxulp=8)
            # eff_gamma = 1 - resid_sq/acc_sq carries the ratio's error:
            # 8 ulp of a ratio near 0.77 are up to 16 ulp of an eff_gamma
            # near 0.23 (measured: ring(3) ragged-v8), so 8 ulp at 1.0
            assert abs(j["tel"][3] - p["tel"][3]) <= 8 * EPS, where
            np.testing.assert_array_max_ulp(j["v"], p["v"], maxulp=8)
            if j["lr"] == lr_max:
                assert _bits(p["lr"]) == _bits(j["lr"]), where
            else:
                np.testing.assert_array_max_ulp(j["lr"], p["lr"], maxulp=8)
            for n in NAMES:
                np.testing.assert_array_equal(_bits(j["mem"][n]),
                                              _bits(p["mem"][n]),
                                              err_msg=f"{where} mem {n}")
                if _bits(p["lr"]) == _bits(j["lr"]):
                    np.testing.assert_array_equal(
                        _bits(j["upd"][n]), _bits(p["upd"][n]),
                        err_msg=f"{where} update {n}")
                else:
                    # lr below its cap reads v, whose sum order differs
                    # (a few ulp, measured <= 2 in lr): own + lr*e then
                    # moves by |d lr|*|e| <= 8 eps * lr * max|e|
                    assert_upd_close(j["upd"][n], p["upd"][n], j["lr"],
                                     where)
            rows = p["rows"]
            assert rows.shape[0] == t.degree + 1, where
            # the own row: JAX's bucket payload, then the dense lanes
            np.testing.assert_array_equal(rows[0, :tw], j["payload"],
                                          err_msg=f"{where} own payload")
            # each received row is that neighbour's own row
            for d, src in enumerate(t.neighbors(rank)):
                np.testing.assert_array_equal(
                    rows[d + 1], got[src][rnd]["rows"][0],
                    err_msg=f"{where} row from {src}")
            dec = decode_buckets(plan, torch.from_numpy(rows[:1, :tw]))
            for ln in plan.leaves:
                if ln.dense:
                    continue
                vals, idx = dec[ln.index]
                np.testing.assert_array_equal(
                    _bits(vals[0].numpy()), _bits(j["dec"][ln.index][0]),
                    err_msg=f"{where} decoded own values {ln.index}")
                np.testing.assert_array_equal(
                    idx[0].numpy(), j["dec"][ln.index][1],
                    err_msg=f"{where} decoded own indices {ln.index}")
    if cfg_kw:
        # the case exists to take the step below its cap
        assert any(jr[r]["lr"] < lr_max for jr in
                   _jax_rounds(topo_name, W, case) for r in range(W))
    if t.degree:
        # the consensus mix is not the local update: updates differ
        assert not np.array_equal(got[0][0]["upd"][NAMES[0]],
                                  got[1][0]["upd"][NAMES[0]])


@pytest.fixture(scope="module")
def workers():
    """The gloo workers of W = 2, 3 and 4, started together and left to
    run while the JAX references compile; W = 1 runs in this process."""
    return {2: ow.Spawned(gw.gossip_cases, 2),
            3: ow.Spawned(gw.gossip_cases, 3),
            4: ow.Spawned(gw.four_workers, 4)}


@pytest.fixture(scope="module")
def four(workers):
    return workers[4].result()


@pytest.mark.parametrize("topo_name,W,case", [
    (t, w, c) for (t, w), cases in gw.PLAN.items() for c in cases],
    ids=lambda x: str(x))
def test_exchange_matches_jax(topo_name, W, case, workers):
    _jax_rounds(topo_name, W, case)          # compiles while workers run
    if W == 1:
        got = {0: {(topo_name, case): gw.gossip_case(0, 1, topo_name,
                                                     case)}}
    else:
        got = workers[W].result()
    _check_case(topo_name, W, case,
                {r: got[r]["cases"][(topo_name, case)] if W == 4
                 else got[r][(topo_name, case)] for r in range(W)})


def test_one_worker_equals_bucketed():
    """At W = 1 (ring(1), no edge) gossip is bucketed: updates, EF memory,
    bytes and telemetry bit for bit, no P2P operation, v 0 and lr 1."""
    sent = []
    real = dist.batch_isend_irecv
    dist.batch_isend_irecv = lambda ops: sent.append(ops) or real(ops)
    try:
        for case in ("block-v8", "topk-v32", "ragged-v8"):
            kw, adaptive, _ = gw.CASES[case]
            comp = Compressor(**kw)
            gt = f32(0.07) if adaptive else None
            g, m = ow.exchange_inputs(3, 4)
            b = ow.run_exchange(g, m, comp, "bucketed", gt, eta=gw.ETA)
            o = ow.run_exchange(g, m, comp, "gossip", gt, eta=gw.ETA,
                                ctx=gs.GossipCtx(
                                    topo.build_topology("ring", 1),
                                    gs.GossipConfig(), gs.GossipState.init()))
            for n in NAMES:
                np.testing.assert_array_equal(b[0][n], o[0][n])
                np.testing.assert_array_equal(
                    _bits(b[1][n].numpy()), _bits(o[1][n].numpy()))
            assert b[2:5] == o[2:5]
            assert float(o[5].v) == 0.0 and float(o[5].lr) == 1.0
    finally:
        dist.batch_isend_irecv = real
    assert sent == []


# ---------------------------------------------------------------------------
# the golden claim and gossip_mix on 4 workers
# ---------------------------------------------------------------------------

def _np_topk_decode(acc, k):
    out = np.zeros_like(acc)
    for r in range(acc.shape[0]):
        idx = np.argsort(-np.abs(acc[r]))[:k]
        out[r, idx] = acc[r, idx]
    return out


@pytest.mark.parametrize("topo_name", ["ring", "exp"])
def test_steps_match_mixing_matrix_simulation(topo_name, four):
    """K steps on 4 gloo workers == the collective-free float64 simulation
    driven by ``Topology.mixing_matrix()``, with JAX's tolerances."""
    W = 4
    t = topo.build_topology(topo_name, W)
    cfg = gs.GossipConfig()
    k = Compressor(**gw.SIM_COMP).k_for(gw.SIM_D)
    x0, c = gw.sim_data(W)
    Wm = t.mixing_matrix()
    xw, xb = (x0[n].astype(np.float64) for n in ("w", "b"))
    cw, cb = (c[n].astype(np.float64) for n in ("w", "b"))
    mw = np.zeros_like(xw)
    v = np.zeros(W)
    n_tot = gw.SIM_L * gw.SIM_D + gw.SIM_DB
    eta = gw.SIM_ETA
    for _ in range(gw.SIM_K):
        acc_w = mw + eta * (xw - cw)
        dec = np.stack([_np_topk_decode(acc_w[i], k) for i in range(W)])
        acc_b = eta * (xb - cb)
        mix_w = np.einsum("ij,jld->ild", Wm, dec)
        mix_b = Wm @ acc_b
        e_w, e_b = mix_w - dec, mix_b - acc_b
        err = (e_w.reshape(W, -1) ** 2).sum(1) + (e_b ** 2).sum(1)
        v = cfg.beta * v + (1.0 - cfg.beta) * err / n_tot
        lr = np.minimum(cfg.lr_max, cfg.consensus_lr / (np.sqrt(v)
                                                        + cfg.eps))
        xw = xw - (dec + lr[:, None, None] * e_w)
        xb = xb - (acc_b + lr[:, None] * e_b)
        mw = acc_w - dec
    got = {r: four[r]["sim"][topo_name] for r in range(W)}
    np.testing.assert_allclose(np.stack([got[r][0]["w"] for r in range(W)]),
                               xw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.stack([got[r][0]["b"] for r in range(W)]),
                               xb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.stack([got[r][1]["w"] for r in range(W)]),
                               mw, rtol=1e-4, atol=1e-5)
    assert all(np.all(got[r][1]["b"] == 0.0) for r in range(W))
    np.testing.assert_allclose([got[r][2] for r in range(W)], v, rtol=1e-4)


def _consensus_err(tree):
    return max(float(np.max(np.abs(x - x.mean(0)))) for x in tree.values())


@pytest.mark.parametrize("topo_name", ["ring", "exp"])
def test_gossip_mix_contracts_and_matches_reference(topo_name, four):
    """Uncompressed rounds: monotone contraction, ``mix_reference`` from
    the same input within JAX's 1e-6 (it rounds ``x + w*acc`` twice, the
    round once), JAX's vmapped ``gossip_mix`` bit for bit, and a constant
    tree as a bit-exact fixed point."""
    W = 4
    t = topo.build_topology(topo_name, W)
    jt = jtopo.build_topology(topo_name, W)
    jmix = jax.jit(jax.vmap(lambda tr: jgs.gossip_mix(tr, jt, "data"),
                            axis_name="data"))
    cur = gw.mix_data(W)
    errs = [_consensus_err(cur)]
    for rnd in range(gw.MIX_ROUNDS):
        got = {n: np.stack([four[r]["mix"][topo_name][0][rnd][n]
                            for r in range(W)]) for n in cur}
        want = jmix({n: jnp.asarray(v) for n, v in cur.items()})
        for n in cur:
            np.testing.assert_allclose(got[n], t.mix_reference(cur[n]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(_bits(got[n]),
                                          _bits(np.asarray(want[n])))
        cur = got
        errs.append(_consensus_err(cur))
    # exp(4) is all-to-all: one round reaches the mean up to rounding
    assert all(b < a or b <= 1e-6 for a, b in zip(errs, errs[1:])), errs
    for r in range(W):
        _, const, mixed = four[r]["mix"][topo_name]
        for n in const:
            np.testing.assert_array_equal(_bits(mixed[n]), _bits(const[n]))
