"""The faulty transport, the guarded exchanges and the trainer's fault
flags against the JAX package.

* ``worker_compress_aggregate`` through ``transport="faulty"`` around
  ``bucketed`` (8-bit values), ``perleaf`` (a ragged 10% budget) and
  ``overlap`` at delay 0 and 1, one worker, against JAX's
  exchange in a jitted 1-device ``shard_map``: a round inside the burst,
  then one outside it from the first one's state, guarded (the default)
  and, around perleaf, with ``quarantine=False``;
* the same on 3 gloo workers around ``bucketed`` and ``gossip`` (ring(3))
  with worker 1's rows hit, against JAX's exchange under
  ``jax.jit(jax.vmap(..., axis_name="data"))`` on one CPU device (equal
  to a 3-device ``shard_map`` bit for bit, checked once), guarded and
  unguarded: W = 3 is where the guarded mean's true division by the
  valid-row count and the unguarded one's product with f32(1/3) part;
* ``OptimizerConfig``'s fault refusals and the CLI's fault flags
  (defaults and help) word for word, and the trainer's seams through the
  CLI;
* DESIGN.md §16's acceptance pair on the port
  (``tests/test_golden_convergence.py:160-270``): a 10-step NaN burst on
  the golden quadratic lands within 1.05x + 5e-4 of the clean run with
  quarantine, the breaker alone skips 1-10 steps and recovers, neither
  is pinned divergent; the quarantine arm's first 120 steps are held
  against JAX's.

Each JAX reference (the one-worker cases, the three-worker runs, the
§16 trajectory) is one jitted program: compiles are most of this file's
CPU time.

Bit for bit where the exchange is exact: EF memory, byte counts,
quarantined rows and the updates (a non-finite entry of an unguarded
round equal as a value, NaN to NaN), except the dense leaves' all-reduce
at W = 3, within 8 eps of the leaf's max |update| (gloo and XLA sum the
rows in other orders).  The §16 trajectories carry a
stated tolerance: JAX's gradient and loss sums and the port's reduce in
another order.
"""
import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.comm.faults import FaultConfig as JFaultConfig
from repro.comm.faults import FaultCtx as JFaultCtx
from repro.comm.gossip import GossipConfig as JGossipConfig
from repro.comm.gossip import GossipCtx as JGossipCtx
from repro.comm.gossip import GossipState as JGossipState
from repro.comm.overlap import OverlapConfig as JOverlapConfig
from repro.comm.overlap import OverlapCtx as JOverlapCtx
from repro.comm.overlap import OverlapState as JOverlapState
from repro.comm.overlap import init_overlap_state as jinit_overlap
from repro.comm.topology import build_topology as jbuild_topology
from repro.compat import shard_map
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import ArmijoConfig as JArmijoConfig
from repro.core import Compressor as JCompressor
from repro.core.armijo import armijo_search as jarmijo
from repro.core.armijo import next_alpha_max as jnext_alpha_max
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.health import HealthState as JHealth
from repro.core.health import advance_health as jadvance_health
from repro.core.health import all_finite as jall_finite
from repro.data.synthetic import interpolated_regression as jregression
from repro_torch.comm import exchange, faults
from repro_torch.comm import overlap as ov
from repro_torch.comm.bucket import build_bucket_plan
from repro_torch.configs.base import OptimizerConfig
from repro_torch.convert import to_torch
from repro_torch.core.armijo import ArmijoConfig, armijo_search, \
    next_alpha_max
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.core.health import HealthState, advance_health, all_finite
from repro_torch.data.synthetic import interpolated_regression
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.utils import tree_flatten

import torch_fault_workers as fw
import torch_overlap_workers as ow

torch.set_num_threads(2)

f32 = np.float32
SHAPES, STACKED, NAMES = fw.SHAPES, fw.STACKED, fw.NAMES
SMASK = dict(zip(NAMES, STACKED))
REPO = pathlib.Path(__file__).resolve().parents[1]
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same(want, got, exact, where):
    """Bit for bit when ``exact``, else equal as values (NaN to NaN: an
    unguarded round's NaN payloads need not share their bits)."""
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


# ---------------------------------------------------------------------------
# one worker: every transport through the wrapper, against a shard_map
# ---------------------------------------------------------------------------

#: (inner transport, compressor, gamma_t, campaign, overlap delay)
ONE = {
    "bucketed-v8": ("bucketed", dict(gamma=0.05, method="topk",
                                     min_compress_size=64, value_bits=8),
                    None, dict(seed=3, p_nonfinite=0.5, p_bitflip=0.5,
                               p_zero_row=0.2), None),
    "perleaf-ragged": ("perleaf", dict(gamma=0.04, max_gamma=0.1,
                                       method="topk", min_compress_size=64,
                                       value_bits=16),
                       0.07, dict(seed=4, p_count=0.6, p_bitflip=0.6), None),
    "overlap-d0": ("overlap", dict(gamma=0.05, method="topk",
                                   min_compress_size=64),
                   None, dict(seed=4, p_nonfinite=0.7), 0),
    "overlap-d1": ("overlap", dict(gamma=0.05, method="topk",
                                   min_compress_size=64),
                   None, dict(seed=8, p_nonfinite=0.7, p_bitflip=0.4), 1),
}
START = fw.START


#: the one-worker cases the test runs: every case guarded, ragged perleaf
#: also unguarded
ONE_RUNS = [(c, True) for c in ONE] + [("perleaf-ragged", False)]


def _jax_one_worker(case, quarantine):
    """JAX's faulty exchange of ``case``; the step and the inner
    transport's state are traced inputs."""
    inner, kw, gt, fkw, delay = ONE[case]
    comp = JCompressor(**kw)
    cfg = JFaultConfig(start_step=START, n_steps=1, quarantine=quarantine,
                       **fkw)

    def worker(g, m, step, state):
        ctx = None
        if inner == "overlap":
            ctx = JOverlapCtx(JOverlapConfig(delay=delay),
                              JOverlapState(*state))
        return jwca(g, m, jnp.float32(fw.ETA), comp, ("data",),
                    stacked_mask=SMASK,
                    gamma_t=None if gt is None else jnp.float32(gt),
                    transport="faulty", transport_ctx=JFaultCtx(
                        cfg=cfg, step=step, inner=inner, inner_ctx=ctx))
    return worker


@functools.lru_cache(maxsize=None)
def _jax_one_rounds():
    """Both rounds of every case in ``ONE_RUNS`` through JAX, each round
    from the case's own previous outputs: {(case, quarantine): [round 0,
    round 1]} as NumPy.  All cases are one jitted 1-device ``shard_map``,
    so they cost one compile."""
    workers = {run: _jax_one_worker(*run) for run in ONE_RUNS}

    def all_cases(ins):
        return {run: workers[run](*ins[run]) for run in ONE_RUNS}
    fn = jax.jit(shard_map(all_cases, mesh=jax.make_mesh((1,), ("data",)),
                           in_specs=P(), out_specs=P(),
                           axis_names={"data"}))
    _, m0 = fw.exchange_inputs(41, 42)
    carry = {run: ({n: jnp.asarray(v) for n, v in m0.items()},
                   _jax_state(run[0])) for run in ONE_RUNS}
    rounds = {run: [] for run in ONE_RUNS}
    for rnd in range(2):
        g = {n: jnp.asarray(v)
             for n, v in fw.exchange_inputs(43 + rnd, 0)[0].items()}
        outs = fn({run: (g, mem, jnp.int32(START + rnd), st)
                   for run, (mem, st) in carry.items()})
        for run, out in outs.items():
            out = jax.tree.map(np.asarray, out)
            rounds[run].append(out)
            # fresh arrays: the outputs' shardings would recompile
            carry[run] = ({n: jnp.asarray(x) for n, x in out[1].items()},
                          tuple(jnp.asarray(x)
                                for x in jax.tree.leaves(out[5])))
    return rounds


def _jax_state(case):
    inner, kw, _, _, _ = ONE[case]
    if inner == "overlap":
        return tuple(jax.tree.leaves(jinit_overlap(SHAPES, STACKED,
                                                   JCompressor(**kw))))
    return ()


def _port_ctx(case, state):
    inner, kw, _, _, delay = ONE[case]
    if inner == "overlap":
        return ov.OverlapCtx(ov.OverlapConfig(delay=delay), state)
    return None


def _port_state(case):
    inner, kw, _, _, _ = ONE[case]
    if inner == "overlap":
        return ov.init_overlap_state(SHAPES, STACKED, Compressor(**kw))
    return None


@pytest.mark.parametrize("case,quarantine", ONE_RUNS,
                         ids=lambda x: str(x))
def test_one_worker_faulty_exchange_matches_jax(case, quarantine,
                                               one_thread):
    inner, kw, gt, fkw, _ = ONE[case]
    jrounds = _jax_one_rounds()[(case, quarantine)]
    cfg = faults.FaultConfig(start_step=START, n_steps=1,
                             quarantine=quarantine, **fkw)
    tmem = to_torch(fw.exchange_inputs(41, 42)[1])
    tst = _port_state(case)
    quar = []
    for rnd, jout in enumerate(jrounds):
        g = fw.exchange_inputs(43 + rnd, 0)[0]
        tout = worker_compress_aggregate(
            to_torch(g), tmem, f32(fw.ETA), Compressor(**kw),
            stacked_mask=SMASK, gamma_t=None if gt is None else f32(gt),
            transport="faulty", transport_ctx=faults.FaultCtx(
                cfg=cfg, step=START + rnd, inner=inner,
                inner_ctx=_port_ctx(case, tst)))
        where = f"{case} quarantine={quarantine} round {rnd}"
        exact = quarantine or rnd == 1
        for n in NAMES:
            _same(np.asarray(jout[0][n]), tout[0][n].numpy(), quarantine,
                  f"{where} update {n}")
            _same(np.asarray(jout[1][n]), tout[1][n].numpy(), quarantine,
                  f"{where} memory {n}")
        assert (float(tout[2]), float(tout[3])) == \
            (float(jout[2]), float(jout[3])), where
        assert float(tout[4].rows_quarantined) == \
            float(jout[4].rows_quarantined), where
        quar.append(float(tout[4].rows_quarantined))
        if exact:
            for f in ("ef_backlog", "cosine", "decode_error"):
                np.testing.assert_array_max_ulp(
                    np.float32(getattr(jout[4], f)),
                    np.float32(getattr(tout[4], f)), maxulp=8)
        if inner == "overlap":
            np.testing.assert_array_equal(tout[5].payload.numpy(),
                                          jout[5].payload.view(np.int32))
            assert float(tout[5].eff_wire) == float(jout[5].eff_wire)
        else:
            assert tout[5] == () and jout[5] == ()
        tmem, tst = tout[1], tout[5]
    # the burst hits round 0 only; quarantine counts only under guards,
    # and at delay 1 round 1 decodes round 0's (clean) payload
    if quarantine:
        assert quar[0] > 0 or case == "overlap-d1"
        assert quar[1] == 0 or case == "overlap-d1"
    else:
        assert quar == [0.0, 0.0]


def test_out_of_window_equals_inner_transport():
    """Outside the burst the wrapper is its inner transport bit for bit,
    and inside a campaign that hits no row it launches nothing and
    returns the gathered rows themselves."""
    comp = Compressor(gamma=0.05, method="topk", min_compress_size=64,
                      value_bits=8)
    g, m = fw.exchange_inputs(5, 6)
    cfg = faults.FaultConfig(p_bitflip=1.0, p_nonfinite=1.0, start_step=9)
    for inner in ("bucketed", "perleaf"):
        a = worker_compress_aggregate(to_torch(g), to_torch(m), f32(0.3),
                                      comp, stacked_mask=SMASK,
                                      transport=inner)
        b = worker_compress_aggregate(
            to_torch(g), to_torch(m), f32(0.3), comp, stacked_mask=SMASK,
            transport="faulty",
            transport_ctx=faults.FaultCtx(cfg=cfg, step=8, inner=inner))
        assert b[5] == ()
        for x, y in zip(a[:2], b[:2]):
            for n in NAMES:
                assert torch.equal(x[n].view(torch.int32),
                                   y[n].view(torch.int32))
        assert (a[2], a[3]) == (b[2], b[3])
        assert float(b[4].rows_quarantined) == 0.0


# ---------------------------------------------------------------------------
# three workers: bucketed and gossip, against a vmapped exchange
# ---------------------------------------------------------------------------

W3 = 3


#: the three-worker runs: each case guarded and unguarded
W3_RUNS = [(c, q) for c in fw.CASES for q in (True, False)]


def _jax_w3_worker(case, quarantine):
    inner, kw, fkw = fw.CASES[case]
    comp = JCompressor(**kw)
    cfg = JFaultConfig(start_step=fw.START, n_steps=1, quarantine=quarantine,
                       **fkw)

    def worker(g, m, step, v, lr):
        ctx = None
        if inner == "gossip":
            ctx = JGossipCtx(jbuild_topology("ring", W3), JGossipConfig(),
                             JGossipState(v=v, lr=lr))
        return jwca(g, m, jnp.float32(fw.ETA), comp, ("data",),
                    stacked_mask=SMASK, transport="faulty",
                    transport_ctx=JFaultCtx(cfg=cfg, step=step, inner=inner,
                                            inner_ctx=ctx))
    return jax.vmap(worker, axis_name="data")


@functools.lru_cache(maxsize=None)
def _jax_rounds_w3():
    """Both rounds of every run in ``W3_RUNS`` through JAX's exchange
    under ``jax.vmap(..., axis_name="data")``, all runs in one jit (one
    compile): {(case, quarantine): [(update, memory, wire, eff,
    telemetry, (v, lr)) per round]} as NumPy."""
    workers = {run: _jax_w3_worker(*run) for run in W3_RUNS}
    fn = jax.jit(lambda ins: {run: workers[run](*ins[run])
                              for run in W3_RUNS})
    carry = {}
    for case, q in W3_RUNS:
        idx = list(fw.CASES).index(case)
        carry[(case, q)] = ({n: jnp.asarray(np.stack(
            [fw.inputs(idx, r, 0)[1][n] for r in range(W3)]))
            for n in NAMES}, jnp.zeros((W3,), jnp.float32),
            jnp.zeros((W3,), jnp.float32))
    rounds = {run: [] for run in W3_RUNS}
    for rnd in range(2):
        ins = {}
        for (case, q), (mem, v, lr) in carry.items():
            idx = list(fw.CASES).index(case)
            g = [fw.inputs(idx, r, rnd)[0] for r in range(W3)]
            ins[(case, q)] = ({n: jnp.asarray(np.stack([x[n] for x in g]))
                               for n in NAMES}, mem,
                              jnp.full((W3,), fw.START + rnd, jnp.int32),
                              v, lr)
        for run, out in fn(ins).items():
            mem, v, lr = carry[run]
            mem = {n: jnp.asarray(np.asarray(x)) for n, x in out[1].items()}
            if fw.CASES[run[0]][0] == "gossip":
                v, lr = (jnp.asarray(np.asarray(out[5].v)),
                         jnp.asarray(np.asarray(out[5].lr)))
            carry[run] = (mem, v, lr)
            rounds[run].append(jax.tree.map(np.asarray, out[:5]) + (
                (np.asarray(v), np.asarray(lr)),))
    return rounds


@pytest.fixture(scope="module")
def three():
    """3 gloo workers, started at once and left to run while the JAX
    references compile; forked from one server that imports torch once."""
    return ow.Spawned(fw.all_fault_rounds, W3,
                      preload=("torch_overlap_workers", "torch_fault_workers"))


@pytest.mark.parametrize("case,quarantine", W3_RUNS, ids=lambda x: str(x))
def test_three_workers_match_jax(case, quarantine, three):
    jrounds = _jax_rounds_w3()[(case, quarantine)]
    got = three.result()
    plan = build_bucket_plan(SHAPES, STACKED, Compressor(**fw.CASES[case][1]))
    dense = {NAMES[i] for i in plan.dense_ids}
    for rnd, j in enumerate(jrounds):
        for r in range(W3):
            p = got[r][(case, quarantine)][rnd]
            where = f"{case} quarantine={quarantine} round {rnd} rank {r}"
            for n in NAMES:
                if case == "bucketed" and n in dense:
                    # the dense leaves' all-reduce: gloo and XLA sum the
                    # three rows in different orders (no verdict there)
                    err = float(np.abs(j[0][n][r] - p["upd"][n]).max())
                    assert err <= 8 * EPS * float(np.abs(j[0][n][r]).max()), \
                        (where, n, err)
                    continue
                _same(j[0][n][r], p["upd"][n], quarantine,
                      f"{where} update {n}")
                _same(j[1][n][r], p["mem"][n], quarantine,
                      f"{where} memory {n}")
            assert (p["wire"], p["eff"]) == (float(j[2][r]),
                                             float(j[3][r])), where
            assert p["quar"] == float(j[4].rows_quarantined[r]), where
            if case == "gossip" and quarantine:
                # v sums whole leaves in XLA's order and torch's (PR 26's
                # 8 ulp); lr saturates at lr_max here, bit for bit
                np.testing.assert_array_max_ulp(f32(j[5][0][r]),
                                                f32(p["v"]), maxulp=8)
                assert _bits(p["lr"]) == _bits(j[5][1][r]), where
            elif case == "gossip":
                _same(j[5][0][r], f32(p["v"]), False, where)
    quar0 = [got[r][(case, quarantine)][0]["quar"] for r in range(W3)]
    if quarantine:
        # every worker quarantines rows of the burst round: under bucketed
        # worker 1's (each decodes all gathered rows), under gossip its
        # own or its neighbours'
        assert all(q > 0 for q in quar0), quar0
        for r in range(W3):
            assert all(np.isfinite(x).all() for x in
                       got[r][(case, quarantine)][0]["upd"].values())
    else:
        assert quar0 == [0.0] * W3


def test_w3_means_follow_jitted_jax():
    """What the W = 3 cases rest on: the guarded mean divides by the
    valid-row count (3 on a clean wire) as a true division, the unguarded
    one multiplies by f32(1/3), and the two differ in the last bit."""
    from repro_torch.core.dcsgd import valid_row_mean
    x = np.random.default_rng(0).standard_normal((1, 20000)).astype(f32)
    guarded = np.asarray(jax.jit(lambda a, n: a / jnp.maximum(n, 1.0))(
        x, jnp.float32(3.0)))
    unguarded = np.asarray(jax.jit(lambda a: a / 3)(x))
    got, quar = valid_row_mean(torch.from_numpy(x),
                               torch.ones((3, 1), dtype=torch.bool))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(guarded))
    assert float(quar) == 0.0
    np.testing.assert_array_equal(
        _bits((torch.from_numpy(x) * float(f32(1) / f32(3))).numpy()),
        _bits(unguarded))
    assert (_bits(guarded) != _bits(unguarded)).any()


# ---------------------------------------------------------------------------
# the config's refusals, the CLI's flags and the trainer's seams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kind="sgd"), dict(kind="sls"), dict(kind="dense"),
    dict(downlink="compressed"), dict(shard_local_topk=True),
    dict(kind="sgd", downlink="compressed"),
    dict(max_consecutive_skips=-1)],
    ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_config_refusals_match_jax(kw):
    on = dict(p_bitflip=0.1)
    with pytest.raises(ValueError) as e:
        JOptimizerConfig(faults=JFaultConfig(**on), **kw)
    with pytest.raises(ValueError) as t:
        OptimizerConfig(faults=faults.FaultConfig(**on), **kw)
    assert str(t.value) == str(e.value)
    for kind in ("csgd_asss", "nonadaptive", "acgd"):
        JOptimizerConfig(kind=kind, faults=JFaultConfig(**on))
        OptimizerConfig(kind=kind, faults=faults.FaultConfig(**on))
    assert OptimizerConfig().faults == faults.FaultConfig()


def _jax_fault_flags():
    """The JAX CLI's fault flags: {flag: (default, action, help)}, read
    from its source (its parser lives inside ``main``)."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "add_argument" and node.args:
            flag = ast.literal_eval(node.args[0])
            if flag.startswith("--fault") or flag == "--no-quarantine":
                kw = {k.arg: k.value for k in node.keywords}
                out[flag] = tuple(
                    ast.literal_eval(kw[k]) if k in kw else None
                    for k in ("default", "action", "help"))
    return out


def test_cli_flags_match_jax():
    want = _jax_fault_flags()
    assert len(want) == 9
    parser_actions = {}
    real = train_cli.argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        parser_actions.update({o: act for act in self._actions
                               for o in act.option_strings})
        return real(self, *a, **k)
    train_cli.argparse.ArgumentParser.parse_args = grab
    try:
        args = train_cli.parse_args([])
    finally:
        train_cli.argparse.ArgumentParser.parse_args = real
    for flag, (default, action, help_) in want.items():
        act = parser_actions[flag]
        assert act.help == help_, flag
        if action == "store_true":
            assert act.const is True and act.default is False, flag
        else:
            assert act.default == default, flag
    cfg = faults.FaultConfig(
        seed=args.fault_seed, p_bitflip=args.fault_bitflip,
        p_count=args.fault_count, p_nonfinite=args.fault_nonfinite,
        p_zero_row=args.fault_zero_row, worker=args.fault_worker,
        start_step=args.fault_start_step, n_steps=args.fault_steps,
        quarantine=not args.no_quarantine)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JFaultConfig())


CLI = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
       "4", "--compress-method", "block_topk", "--log-every", "1"]


def test_cli_nonfinite_round_quarantines_and_freezes(capsys):
    """``--fault-nonfinite 1.0`` on step 1 of 3 through the CLI: step 0
    is the clean run's, step 1 quarantines every compressed row (their
    count the sum of L over the compressed leaves) and keeps every
    compressed leaf's EF memory, nothing is skipped, and the log line
    shows ``quar=``; with ``--no-quarantine`` the step is skipped by the
    breaker instead."""
    clean_log, clean_p, clean_s = train_cli.run(CLI + ["--steps", "1"])
    burst = ["--fault-nonfinite", "1.0", "--fault-start-step", "1",
             "--fault-steps", "1"]
    one_log, _, one_s = train_cli.run(CLI + ["--steps", "1"] + burst)
    for a, b in zip(tree_flatten(one_s.memory)[0],
                    tree_flatten(clean_s.memory)[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    log, params, state = train_cli.run(CLI + ["--steps", "2"] + burst)
    assert "quar=" in capsys.readouterr().out
    leaves = tree_flatten(params)[0]
    plan = build_bucket_plan([p.shape for p in leaves],
                             tree_flatten(lm.stacked_mask(params))[0],
                             Compressor(gamma=0.01, method="block_topk"))
    rows = sum(ln.L for ln in plan.leaves if not ln.dense)
    assert [m["rows_quarantined"] for m in log] == [0.0, float(rows)]
    assert [m["steps_skipped"] for m in log] == [0.0, 0.0]
    assert all(np.isfinite(p.numpy()).all() for p in leaves)
    mem_after, mem_before = tree_flatten(state.memory)[0], \
        tree_flatten(one_s.memory)[0]
    for ln in plan.leaves:
        if not ln.dense:
            assert torch.equal(mem_after[ln.index], mem_before[ln.index])
    assert log[0] == {**clean_log[0], "step_s": log[0]["step_s"]}
    ng = train_cli.main(CLI + ["--steps", "2", "--no-quarantine"] + burst)
    assert [m["steps_skipped"] for m in ng] == [0.0, 1.0]
    assert [m["rows_quarantined"] for m in ng] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# DESIGN.md §16's acceptance pair on the port
# ---------------------------------------------------------------------------

SEED, D, N, BATCH, GMAX = 0, 256, 512, 32, 0.04
BURST = dict(seed=7, p_nonfinite=1.0, start_step=100, n_steps=10)
ACFG = dict(sigma=0.1, a_scale=0.3)


@pytest.fixture
def one_thread():
    """Small tensors: one intra-op thread spends the least CPU time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burst_steps(state, t0, t1, cfg, breaker):
    """Steps ``t0 .. t1-1`` of ``tests/test_golden_convergence.py``'s
    ``_burst_trajectory`` on the port from ``state`` = (w, m, amax,
    health, rng): CSGD-ASSS on the golden quadratic through
    ``worker_compress_aggregate`` on one worker, under the ``faulty``
    wrapper when ``cfg`` is given, with the train step's breaker.
    Returns (state, per-step (w, health))."""
    A, b, _ = _regression()
    comp = Compressor(gamma=GMAX, min_compress_size=1)
    acfg = ArmijoConfig(**ACFG)
    w, m, amax, health, rng = state
    trace = []
    for t in range(t0, t1):
        idx = torch.from_numpy(rng.integers(0, N, BATCH))
        Ai, bi = A[idx], b[idx]

        def loss_fn(ww):
            return ((Ai @ ww - bi) ** 2).mean()
        wg = w.clone().requires_grad_(True)
        g = torch.autograd.grad(loss_fn(wg), wg)[0]
        res = armijo_search(loss_fn, w, g, amax, acfg)
        name, ctx = "bucketed", None
        if cfg is not None:
            name, ctx = "faulty", faults.FaultCtx(cfg=cfg, step=t,
                                                  inner="bucketed")
        out = worker_compress_aggregate(g, m, res.eta, comp, transport=name,
                                        transport_ctx=ctx)
        upd, m_new, tel = out[0], out[1], out[4]
        step_ok = bool(np.isfinite(res.f0)) and bool(all_finite(upd))
        cand = (w - upd, m_new, next_alpha_max(res.alpha, acfg))
        if breaker and not step_ok:
            cand = (w, m, amax)
        health = advance_health(health, step_ok, t,
                                float(tel.rows_quarantined))
        w, m, amax = cand
        trace.append((w.numpy().copy(), health))
    return (w, m, amax, health, rng), trace


@functools.lru_cache(maxsize=None)
def _regression():
    return interpolated_regression(N, D, feature_std=1.0, seed=SEED)


@functools.lru_cache(maxsize=None)
def _before_burst():
    """The first ``BURST["start_step"]`` steps, shared by every arm: a
    campaign outside its burst is its inner transport bit for bit, and
    with every row valid the guarded mean is the unguarded one at one
    worker.  Returns (state as NumPy, per-step (w, health))."""
    acfg = ArmijoConfig(**ACFG)
    state = (torch.zeros(D), torch.zeros(D), f32(acfg.alpha0),
             HealthState(), np.random.default_rng(SEED))
    state, trace = _burst_steps(state, 0, BURST["start_step"], None, True)
    w, m, amax, health, rng = state
    return (w.numpy().copy(), m.numpy().copy(), amax, health,
            rng.bit_generator.state), trace


def _port_burst(fault_kw=None, breaker=True, steps=600):
    """The port's ``_burst_trajectory`` for ``steps`` steps: (HealthState,
    w, per-step (w, health))."""
    (w, m, amax, health, rng_state), head = _before_burst()
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    state = (torch.from_numpy(w.copy()), torch.from_numpy(m.copy()), amax,
             health, rng)
    cfg = faults.FaultConfig(**fault_kw) if fault_kw else None
    state, trace = _burst_steps(state, BURST["start_step"], steps, cfg,
                                breaker)
    return state[3], state[0], head + trace


def _tail_loss(trace, t0, t1):
    """The full loss at the Polyak average of w over steps ``t0 .. t1-1``
    of a trajectory (``_burst_trajectory``'s tail average)."""
    A, b, _ = _regression()
    wbar = np.mean([trace[t][0].astype(np.float64) for t in range(t0, t1)],
                   axis=0)
    return float((((A.double() @ torch.from_numpy(wbar)) - b.double())
                  ** 2).mean())


def _jax_burst_trace(steps):
    """JAX's ``_burst_trajectory`` worker (quarantine arm), jitted, its w
    after each of ``steps`` steps."""
    A, b, _ = jregression(N, D, feature_std=1.0, seed=SEED)
    comp = JCompressor(gamma=GMAX, min_compress_size=1)
    acfg = JArmijoConfig(**ACFG)
    cfg = JFaultConfig(**BURST)

    def worker(w, m, amax, health, step, idx):
        def loss_fn(ww):
            r = A[idx] @ ww - b[idx]
            return jnp.mean(r ** 2)
        g = jax.grad(loss_fn)(w)
        res = jarmijo(loss_fn, w, g, amax, acfg)
        out = jwca(g, m, res.eta, comp, ("data",), transport="faulty",
                   transport_ctx=JFaultCtx(cfg=cfg, step=step,
                                           inner="bucketed"))
        upd, m_new, tel = out[0], out[1], out[4]
        step_ok = jnp.isfinite(res.f0) & jall_finite(upd)
        cand = jax.tree.map(lambda a, c: jnp.where(step_ok, a, c),
                            (w - upd, m_new, jnext_alpha_max(res.alpha,
                                                             acfg)),
                            (w, m, amax))
        return (*cand, jadvance_health(health, step_ok, step,
                                       tel.rows_quarantined))
    fn = jax.jit(shard_map(worker, mesh=jax.make_mesh((1,), ("data",)),
                           in_specs=(P(),) * 6, out_specs=P(),
                           axis_names={"data"}))
    w, m = jnp.zeros(D), jnp.zeros(D)
    amax, health = jnp.float32(acfg.alpha0), JHealth.init(())
    rng = np.random.default_rng(SEED)
    trace = []
    for t in range(steps):
        idx = jnp.asarray(rng.integers(0, N, BATCH))
        w, m, amax, health = fn(w, m, amax, health, jnp.int32(t), idx)
        trace.append(np.asarray(w))
    return trace, health


#: the port's w against JAX's over the first 120 steps (the burst at
#: 100-109 included): within this fraction of max |w|.  Both sides'
#: gradient and loss reductions sum in different orders (an ulp a
#: step), which the contraction keeps from growing.
TRACE_RTOL = 1e-4


def test_burst_quarantine_and_breaker_recover(one_thread):
    """Each arm runs JAX's 600 steps and is held against the clean arm by
    its Polyak tail over the last 200 (the breaker arm lags the clean
    one by its skipped steps, still more than 5% at step 300)."""
    h_clean, _, clean = _port_burst()
    loss_clean = _tail_loss(clean, 400, 600)
    assert np.isfinite(loss_clean) and loss_clean < 1e-2, loss_clean
    assert h_clean.steps_skipped == 0 and h_clean.rows_quarantined == 0.0

    h_q, w_q, trace = _port_burst(BURST)
    loss_q = _tail_loss(trace, 400, 600)
    assert torch.isfinite(w_q).all()
    assert h_q.rows_quarantined >= 10.0
    assert h_q.steps_skipped <= 10
    assert loss_q <= 1.05 * loss_clean + 5e-4, (loss_q, loss_clean)

    jtrace, jhealth = _jax_burst_trace(120)
    # after step 120: JAX's counters equal the port's
    h120 = trace[119][1]
    assert float(jhealth.rows_quarantined) == h120.rows_quarantined
    assert int(jhealth.steps_skipped) == h120.steps_skipped
    for t, (jw, (pw, _)) in enumerate(zip(jtrace, trace[:120])):
        err = float(np.abs(jw - pw).max())
        assert err <= TRACE_RTOL * float(np.abs(jw).max()), (t, err)

    h_b, w_b, breaker = _port_burst(dict(quarantine=False, **BURST))
    loss_b = _tail_loss(breaker, 400, 600)
    assert torch.isfinite(w_b).all()
    assert 1 <= h_b.steps_skipped <= 10
    assert h_b.last_good_step > 110
    assert loss_b <= 1.05 * loss_clean + 5e-4, (loss_b, loss_clean)


def test_burst_unguarded_is_pinned_divergent(one_thread):
    """Neither quarantine nor breaker: JAX's 200 steps, its Polyak tail
    over the last 50."""
    _, w_u, trace = _port_burst(dict(quarantine=False, **BURST),
                                breaker=False, steps=200)
    loss_u = _tail_loss(trace, 150, 200)
    assert (not np.isfinite(loss_u)) or not torch.isfinite(w_u).all()
