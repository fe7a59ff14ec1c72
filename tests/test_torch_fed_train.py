"""The federated cohort round of the trainer against the JAX package:
``train_step``'s cohort round (JAX's ``_federated_worker``), its
refusals, the CLI's cohort flags and resume.

* Trainer rounds at one worker with 4 clients against a jitted
  composition of ``_federated_worker``'s lines
  (``tests/torch_trainer_ref.jax_cohort_rounds``, ONE jitted program
  over all cases), each round from the reference's parameters and client
  state: ``csgd_asss`` and ``nonadaptive``, fixed and bernoulli sampling
  with stragglers, per-client and shared linear gamma at a 10% budget,
  ``--dirichlet-alpha``, ``mean``, 8-bit values and a NaN campaign on
  one client's rows.  Tolerances as tests/test_torch_kinds.py: loss,
  grad_sqnorm and alpha rel 1e-5 (a split Armijo trial prints both
  sides of its condition), parameters and every client's EF memory
  within 1e-5 of max |p|; the clients' gamma, rounds, n_evals, the byte
  counts and the health counters exact; the gamma mean within 8 ulp.
* Every refusal of the cohort (``FederatedConfig``'s, the
  ``OptimizerConfig`` compositions, ``build_train_step``'s) word for
  word against JAX's.
* The CLI: JAX's cohort flags (defaults and help), ``--n-clients`` on
  the CPU, JAX's ``--global-batch`` error, resume equal to an
  uninterrupted run, and the breaker freezing every client.
"""
import ast
import dataclasses
import json
import os
import pathlib
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import FederatedConfig as JFederatedConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.comm import exchange
from repro_torch.configs.base import FederatedConfig, OptimizerConfig, \
    RunConfig, ShapeConfig
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_step as ts
from repro_torch.models import lm

import torch_trainer_ref as ref

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FC = ref.FedCase
ADAPTIVE = dict(schedule="linear", gamma=0.04, max_gamma=0.1)
#: the trainer cases, all in ONE jitted JAX program (a compile is ~7
#: CPU-s a case, so each case crosses several dimensions).  32-bit
#: values: at 8 bits an ulp between the two packages' gradients moves a
#: quantized entry by a whole step (the 8-bit exchange is held bit for
#: bit from equal inputs in tests/test_torch_fed.py)
CASES = (
    # fixed sampling, per-client linear gamma, non-IID clients, and a NaN
    # campaign on client 1's rows in round 1
    FC("csgd_asss", dirichlet_alpha=0.5,
       faults=(("p_nonfinite", 1.0), ("worker", 1), ("start_step", 1),
               ("n_steps", 1)), **ADAPTIVE),
    # bernoulli sampling with stragglers, the mean aggregate
    FC("nonadaptive", sampling="bernoulli", rate=0.7, straggler=0.2,
       aggregation="mean", **ADAPTIVE),
    # the shared controller on the round index, two clients a round
    FC("csgd_asss", clients_per_round=2, per_client_gamma=False,
       **ADAPTIVE),
)


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{v}" for k, v in dataclasses.asdict(c).items()
    if v != getattr(FC, k) or k == "kind"))
def test_cohort_rounds_match_jax(case):
    log = ref.run_fed_both(case, CASES)
    part = [m["participants"] for m in log]
    assert part == [float(case.mask(t).sum()) for t in range(len(log))]
    if case.faults:
        # round 1 quarantines client 1's rows, no skip
        quar = [m["rows_quarantined"] for m in log]
        assert quar[0] == 0.0 and quar[1] > 0.0 and quar[2] == quar[1]
        assert all(m["steps_skipped"] == 0.0 for m in log)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

FED = dict(n_clients=4)


@pytest.mark.parametrize("kw", [
    dict(sampling="ring"), dict(aggregation="median"), dict(n_clients=-1),
    dict(n_clients=4, clients_per_round=5),
    dict(n_clients=4, clients_per_round=-1),
    dict(n_clients=4, participation_rate=1.5),
    dict(n_clients=4, straggler_rate=1.0)],
    ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_federated_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as e:
        JFederatedConfig(**kw)
    with pytest.raises(ValueError) as t:
        FederatedConfig(**kw)
    assert str(t.value) == str(e.value)


def _jax_error(kw, micro=1, W=1, fed=FED):
    """JAX's refusal from its configs or ``build_train_step`` on W
    workers (a stand-in mesh: the checks read only its shape)."""
    mesh = types.SimpleNamespace(shape={"data": W}, axis_names=("data",))
    with pytest.raises(ValueError) as e:
        jrun = JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.FED_BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(
                federated=JFederatedConfig(**fed), **kw))
        jbuild_train_step(None, jrun, mesh)
    return str(e.value)


def _port_error(kw, micro=1, W=1, fed=FED):
    with pytest.raises(ValueError) as e:
        run = RunConfig(model=ref.get_smoke_config(ref.ARCH),
                        shape=ShapeConfig(ref.SEQ, ref.FED_BATCH),
                        microbatches=micro, optimizer=OptimizerConfig(
                            federated=FederatedConfig(**fed), **kw))
        ts.init_train_state(lm.init_params(run.model), run, W)
    return str(e.value)


@pytest.mark.parametrize("kw,micro,W,fed", [
    (dict(downlink="compressed"), 1, 1, FED),
    (dict(transport="gossip"), 1, 1, FED),
    (dict(transport="overlap"), 1, 1, FED),
    (dict(kind="acgd"), 1, 1, FED), (dict(kind="sls"), 1, 1, FED),
    (dict(kind="sgd"), 1, 1, FED), (dict(kind="dense"), 1, 1, FED),
    (dict(local_steps=2), 2, 1, FED),
    (dict(local_steps=2, kind="nonadaptive"), 1, 1, FED),
    (dict(shard_local_topk=True), 1, 1, FED),
    (dict(), 2, 1, FED), (dict(), 1, 2, dict(n_clients=3)),
    (dict(gamma_controller=JGammaCfg(schedule="armijo-coupled")), 1, 1,
     FED),
    (dict(gamma_controller=JGammaCfg(schedule="ef-coupled")), 1, 1, FED)],
    ids=lambda x: "-".join(f"{v}" for v in x.values())
    if isinstance(x, dict) else str(x))
def test_refusals_match_jax(kw, micro, W, fed):
    tkw = dict(kw)
    if "gamma_controller" in kw:
        tkw["gamma_controller"] = GammaControllerConfig(
            schedule=kw["gamma_controller"].schedule)
    assert _port_error(tkw, micro, W, fed) == _jax_error(kw, micro, W, fed)


def test_what_jax_takes_the_port_takes():
    """csgd_asss / nonadaptive at fixed and linear gamma, bf16 EF memory
    and a fault campaign compose with the cohort in both packages."""
    from repro.comm.faults import FaultConfig as JFaultConfig
    from repro_torch.comm.faults import FaultConfig
    mesh = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",))
    for kw in (dict(kind="nonadaptive"), dict(ef_dtype="bfloat16"),
               dict(faults=(JFaultConfig(p_bitflip=0.1),
                            FaultConfig(p_bitflip=0.1)))):
        for sched in ("fixed", "linear"):
            jkw = {k: v[0] if k == "faults" else v for k, v in kw.items()}
            tkw = {k: v[1] if k == "faults" else v for k, v in kw.items()}
            run = RunConfig(
                model=ref.get_smoke_config(ref.ARCH),
                shape=ShapeConfig(ref.SEQ, ref.FED_BATCH),
                optimizer=OptimizerConfig(
                    federated=FederatedConfig(n_clients=4),
                    gamma_controller=GammaControllerConfig(schedule=sched),
                    **tkw))
            state = ts.init_train_state(lm.init_params(run.model), run, 2)
            assert state.fed.gamma.shape == (2,) and state.memory is None
            # JAX's build gets past every check (it needs the model only
            # when the step is traced)
            jbuild_train_step(None, JRunConfig(
                model=ref.jax_smoke_config(ref.ARCH),
                shape=JShapeConfig("cli", ref.SEQ, ref.FED_BATCH, "train"),
                optimizer=JOptimizerConfig(
                    federated=JFederatedConfig(n_clients=4),
                    gamma_controller=JGammaCfg(schedule=sched), **jkw)),
                mesh)


# ---------------------------------------------------------------------------
# the CLI, the breaker, resume
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
       "8", "--compress-method", "block_topk", "--log-every", "1",
       "--n-clients", "4"]
FLAGS = ("--n-clients", "--clients-per-round", "--client-sampling",
         "--participation-rate", "--straggler-rate", "--aggregation",
         "--dirichlet-alpha", "--fed-seed")


def _jax_flags():
    """The JAX CLI's cohort flags: {flag: (type, default, choices, help)},
    read from its source (its parser lives inside ``main``)."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "add_argument" and node.args:
            flag = ast.literal_eval(node.args[0])
            if flag in FLAGS:
                kw = {k.arg: k.value for k in node.keywords}
                out[flag] = (ast.unparse(kw["type"]) if "type" in kw
                             else None,) + tuple(
                    ast.literal_eval(kw[k]) if k in kw else None
                    for k in ("default", "choices", "help"))
    return out


def test_cli_flags_match_jax():
    want = _jax_flags()
    assert sorted(want) == sorted(FLAGS)
    parser_actions = {}
    real = train_cli.argparse.ArgumentParser.parse_args

    def grab(self, argv=None):
        for a in self._actions:
            parser_actions.update({s: a for s in a.option_strings})
        return real(self, argv)
    train_cli.argparse.ArgumentParser.parse_args = grab
    try:
        train_cli.parse_args([])
    finally:
        train_cli.argparse.ArgumentParser.parse_args = real
    for flag, (typ, default, choices, help_) in want.items():
        a = parser_actions[flag]
        assert (a.type.__name__ if a.type else None, a.default,
                a.choices, a.help) == (typ, default, choices, help_), flag


def test_cli_runs_a_cohort(capsys):
    log = train_cli.main(CLI + ["--clients-per-round", "3", "--steps", "2",
                                "--max-gamma", "0.1", "--gamma", "0.04",
                                "--gamma-schedule", "linear",
                                "--gamma-ramp-steps", "2",
                                "--dirichlet-alpha", "0.5"])
    out = capsys.readouterr().out
    assert out.count("part=3 ") == 2
    assert [m["participants"] for m in log] == [3.0, 3.0]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert log[1]["gamma"] > log[0]["gamma"]
    with pytest.raises(SystemExit) as e:
        train_cli.main(CLI + ["--global-batch", "6", "--steps", "1"])
    assert str(e.value) == ("--global-batch 6 must divide evenly across "
                            "--n-clients 4")
    with pytest.raises(ValueError, match="does not compose with "
                       "transport='gossip'"):
        train_cli.main(CLI + ["--transport", "gossip", "--steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(CLI[2:] + ["--steps", "1"])


def test_breaker_freezes_every_client():
    """``nonadaptive`` at eta inf: the round's update is non-finite, so
    it is skipped with the parameters and the whole client state it was
    handed; the step, the byte counters and the health advance."""
    run = dataclasses.replace(FC("nonadaptive").run())
    run = dataclasses.replace(run, optimizer=dataclasses.replace(
        run.optimizer, eta=float("inf")))
    params = lm.init_params(run.model)
    state = ts.init_train_state(params, run)
    case = FC("nonadaptive")
    new_params, new_state, m = ts.train_step(
        params, state, {"tokens": torch.from_numpy(case.tokens(0)),
                        "participation": case.mask(0)}, run)
    assert m["consecutive_skips"] == 1.0 and new_state.fed is state.fed
    assert new_params is params and new_state.step == 1
    assert new_state.cum_wire_bytes > 0


def _final(d):
    d = os.path.join(d, "rank_000")
    p = os.path.join(d, f"step_{tckpt.latest_step(d):010d}")
    z = np.load(os.path.join(p, "arrays.npz"))
    with open(os.path.join(p, "manifest.json")) as f:
        return json.load(f), {k: z[k] for k in z.files}


def test_resume_equals_uninterrupted(tmp_path, capsys):
    """3 rounds straight against 2, then ``--resume`` to 3: every logged
    metric and the final checkpoint, every client's state included, bit
    for bit."""
    cli = CLI + ["--clients-per-round", "3", "--client-sampling",
                 "bernoulli", "--participation-rate", "0.8",
                 "--max-gamma", "0.1", "--gamma-schedule", "linear",
                 "--gamma-ramp-steps", "2"]
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    log = train_cli.main(cli + ["--steps", "3", "--ckpt-dir", straight])
    first = train_cli.main(cli + ["--steps", "2", "--ckpt-dir", split,
                                  "--ckpt-every", "1"])
    capsys.readouterr()
    second = train_cli.main(cli + ["--steps", "3", "--ckpt-dir", split,
                                   "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    strip = lambda lg: [{k: v for k, v in m.items() if k != "step_s"}  # noqa
                        for m in lg]
    assert strip(first + second) == strip(log)
    (ms, zs), (mr, zr) = _final(straight), _final(split)
    assert ms == mr
    assert {"state/fed/gamma", "state/fed/rounds", "state/fed/alpha"} <= \
        set(ms["paths"])
    assert sum(p.startswith("state/fed/memory/") for p in ms["paths"]) == \
        sum(p.startswith("params/") for p in ms["paths"])
    for k in zs:
        np.testing.assert_array_equal(np.atleast_1d(zs[k]).view(np.uint8),
                                      np.atleast_1d(zr[k]).view(np.uint8),
                                      err_msg=k)


def test_cohort_rounds_on_two_workers_match_jax(tmp_path):
    """CASES[0] (csgd_asss, per-client linear gamma, non-IID clients, a
    NaN campaign on client 1) on 2 gloo workers, 2 clients each, each
    round from the reference's state: JAX's round at the trainer
    tolerances above (the exchange itself is held to JAX's on 2 workers
    bit for bit in tests/test_torch_fed.py; here only the dense leaves'
    and the metrics' sums group the clients otherwise)."""
    import pickle

    import torch_fed_workers as fw
    import torch_overlap_workers as ow
    case = CASES[0]
    want = ref.jax_cohort_rounds(CASES)[case]
    path = str(tmp_path / "rounds.pkl")
    with open(path, "wb") as f:
        pickle.dump([(i[0], i[1], i[3], i[4]) for i, _ in want], f)
    got = ow.Spawned(fw.cohort_trainer_rounds, 2, case.run(), path,
                     preload=("torch_overlap_workers",
                              "torch_fed_workers")).result()
    for t, (ins, (new_params, new_fst, new_ctx, jm)) in enumerate(want):
        for r in range(2):
            p = got[r][t]
            where = f"round {t} rank {r}"
            rows = slice(2 * r, 2 * r + 2)
            ref.assert_tree_close(new_params, ref.to_torch(p["params"]),
                                  ins[0], f"{where} params")
            ref._assert_memory_close(
                jax.tree.map(lambda x: x[rows], new_fst[0]),
                ref.to_torch(p["mem"]), ins[0], where)
            np.testing.assert_array_equal(p["gamma"].view(np.int32),
                                          new_fst[1][rows].view(np.int32))
            np.testing.assert_array_equal(p["rounds"], new_fst[2][rows])
            np.testing.assert_allclose(p["alpha"], new_fst[3][rows],
                                       rtol=1e-5, err_msg=where)
            m = p["metrics"]
            for k in ("loss", "grad_sqnorm", "alpha"):
                np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5,
                                           err_msg=f"{where} {k}")
            assert (m["n_evals"], m["participants"], m["wire_bytes"],
                    m["effective_wire_bytes"],
                    m["cum_effective_wire_bytes"]) == \
                (float(jm["n_evals"]), float(jm["participants"]),
                 float(jm["wire"]), float(jm["eff"]), float(jm["cum"])), \
                where
            h = new_ctx[1]
            assert p["health"] == (int(h.steps_skipped),
                                   int(h.consecutive_skips),
                                   int(h.last_good_step),
                                   float(h.rows_quarantined)), where
    assert got[0][1]["health"][3] > 0.0
