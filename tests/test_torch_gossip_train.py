"""The trainer on the gossip transport (``--transport gossip``) against the
JAX package.

* 3 rounds of the smoke config at one worker, ``csgd_asss`` and
  ``nonadaptive``, against the jitted reference round of
  tests/torch_trainer_ref.py (its gossip seam), each round from the
  reference's parameters and EF memory, at the tolerances stated there;
  (v, lr) bit for bit (0 and 1: one worker has no neighbour);
* 3 rounds on 4 gloo workers (ring), each worker from the reference's
  per-worker parameters and EF memory, against JAX's gossip round with
  the exchange vmapped over the 4 workers;
* every refusal with JAX's text, and what both packages take;
* the breaker's gossip rule: the group's loss mean alone gates, so a
  non-finite update is written through and the next round is skipped
  with the gossip state frozen;
* one worker equals ``bucketed`` through the CLI, checkpoints carry the
  gossip state, and a resume equals an uninterrupted run, on one worker
  and on 2 gloo workers through the CLI.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm.gossip import GossipConfig as JGossipConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import Compressor as JCompressor
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.comm import exchange
from repro_torch.comm.gossip import GossipConfig
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_step as ts
from repro_torch.models import lm
from repro_torch.utils import tree_leaves

import torch_overlap_workers as workers
import torch_trainer_ref as ref

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["csgd_asss", "nonadaptive"])
def test_gossip_rounds_match_jax_on_one_worker(kind):
    _, state, log = ref.run_both(ref.Case(kind, transport="gossip"))
    assert float(state.gossip.v) == 0.0 and float(state.gossip.lr) == 1.0
    assert "staleness" not in log[-1]


def test_gossip_rounds_match_jax_on_four_workers():
    got = ref.run_gossip_workers(ref.Case("csgd_asss", transport="gossip"),
                                 4)
    # each rank keeps its own model: ring neighbours mix, never average
    # the whole fleet, so the ranks' parameters differ
    last = [tree_leaves(to_torch(got[r][-1]["params"])) for r in range(4)]
    assert not all(torch.equal(a, b) for a, b in zip(last[0], last[2]))
    assert all(got[r][-1]["v"] > 0 for r in range(4))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _jax_error(kw, micro=1):
    with pytest.raises(ValueError) as e:
        jrun = JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(**kw))
        jbuild_train_step(None, jrun, jax.make_mesh((1,), ("data",)))
    return str(e.value)


def _port_error(kw, micro=1):
    with pytest.raises(ValueError) as e:
        RunConfig(model=ref.get_smoke_config(ref.ARCH),
                  shape=ShapeConfig(ref.SEQ, ref.BATCH), microbatches=micro,
                  optimizer=OptimizerConfig(**kw))
    return str(e.value)


@pytest.mark.parametrize("kw,micro", [
    (dict(kind="acgd"), 1), (dict(kind="sls"), 1), (dict(kind="sgd"), 1),
    (dict(kind="dense"), 1), (dict(local_steps=2), 2),
    (dict(local_steps=2, kind="nonadaptive"), 2),
    (dict(shard_local_topk=True), 1), (dict(downlink="compressed"), 1),
    (dict(downlink="compressed", kind="acgd"), 1),
    (dict(kind="acgd", local_steps=2), 2)],
    ids=lambda x: "-".join(f"{v}" for v in x.values())
    if isinstance(x, dict) else str(x))
def test_config_refusals_match_jax(kw, micro):
    kw = dict(kw, transport="gossip")
    assert _port_error(kw, micro) == _jax_error(kw, micro)


@pytest.mark.parametrize("topology", ["ring", "torus", "exp"])
def test_trainer_takes_what_jax_takes(topology):
    """nonadaptive, bf16 EF memory with microbatches and an adaptive
    budget compose with gossip on each topology, in both packages."""
    for kw, micro in ((dict(kind="nonadaptive"), 1),
                      (dict(ef_dtype="bfloat16"), 2), (dict(), 1)):
        RunConfig(model=ref.get_smoke_config(ref.ARCH),
                  shape=ShapeConfig(ref.SEQ, ref.BATCH), microbatches=micro,
                  optimizer=OptimizerConfig(
                      transport="gossip",
                      gossip=GossipConfig(topology=topology),
                      compressor=Compressor(gamma=0.04, max_gamma=0.1),
                      **kw))
        jbuild_train_step(None, JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(
                transport="gossip",
                gossip=JGossipConfig(topology=topology),
                compressor=JCompressor(gamma=0.04, max_gamma=0.1), **kw)),
            jax.make_mesh((1,), ("data",)))


# ---------------------------------------------------------------------------
# the breaker's gossip rule
# ---------------------------------------------------------------------------

def _run(transport, **opt):
    run = ref.Case("nonadaptive", transport=transport).run()
    return dataclasses.replace(run, optimizer=dataclasses.replace(
        run.optimizer, **opt))


@pytest.mark.parametrize("transport", ["bucketed", "gossip"])
def test_breaker_reads_the_loss_alone_under_gossip(transport):
    """``nonadaptive`` rounds at eta 0.1, inf, 0.1.  ``bucketed`` skips the
    inf round (its decoded update is non-finite).  Under gossip the
    updates are per worker and the gate reads the loss mean alone, as
    JAX's does: the inf round is written through, and the next round,
    whose loss is non-finite, is skipped with the parameters, the EF
    memory and the gossip state it was handed."""
    runs = [_run(transport, eta=eta) for eta in (0.1, float("inf"), 0.1)]
    params = lm.init_params(runs[0].model, seed=0)
    state = ts.init_train_state(params, runs[0])
    pipe = TokenPipeline(vocab_size=runs[0].model.vocab_size,
                         seq_len=ref.SEQ, global_batch=ref.BATCH)
    skips = []
    for t, run in enumerate(runs):
        new_params, new_state, m = ts.train_step(params, state,
                                                 pipe.batch(t), run)
        skips.append(m["consecutive_skips"])
        if skips[-1]:
            assert new_state.memory is state.memory
            assert new_state.gossip is state.gossip
            ref.assert_bitwise_equal(new_params, params)
            assert new_state.step == state.step + 1
            break
        params, state = new_params, new_state
    if transport == "gossip":
        assert skips == [0.0, 0.0, 1.0]
        assert not np.isfinite(m["loss"])
    else:
        assert skips == [0.0, 1.0]


# ---------------------------------------------------------------------------
# the CLI, checkpoints, resume
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
       "4", "--compress-method", "block_topk", "--log-every", "1"]


def test_cli_flags_and_refusals():
    args = train_cli.parse_args([])
    want = JGossipConfig()
    assert (args.topology, args.consensus_lr, args.consensus_beta,
            args.consensus_lr_max) == (want.topology, want.consensus_lr,
                                       want.beta, want.lr_max)
    assert OptimizerConfig().gossip == OptimizerConfig(
        transport="gossip").gossip
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--topology", "star"])
    gossip = CLI + ["--steps", "1", "--transport", "gossip"]
    for extra, match in ((["--opt", "acgd"], "needs a compressing"),
                         (["--opt", "sls"], "needs a compressing"),
                         (["--downlink", "compressed"], "never materializes"),
                         (["--local-steps", "2", "--microbatches", "2"],
                          "does not compose with local_steps"),
                         (["--consensus-beta", "1.0"],
                          r"gossip beta must be in \[0, 1\)"),
                         (["--consensus-lr-max", "0"],
                          "gossip lr_max must be > 0")):
        with pytest.raises(ValueError, match=match):
            train_cli.main(gossip + extra)


@pytest.mark.parametrize("bits", ["32", "8"])
def test_one_worker_equals_bucketed_through_the_cli(bits):
    """What chip_smoke.py's phase 4j checks on the card, here on the CPU:
    gossip at one worker (ring, torus and exp alike) against bucketed
    from the same seed, parameters and EF memory bit for bit, the same
    bytes and gamma_t."""
    base = CLI + ["--steps", "2", "--value-bits", bits]
    b_log, b_params, b_state = train_cli.run(base)
    for topology in ("ring", "torus", "exp"):
        g_log, g_params, g_state = train_cli.run(
            base + ["--transport", "gossip", "--topology", topology])
        ref.assert_bitwise_equal(g_params, b_params)
        ref.assert_bitwise_equal(g_state.memory, b_state.memory)
        for k in ("wire_bytes", "effective_wire_bytes", "gamma", "loss"):
            assert [m[k] for m in g_log] == [m[k] for m in b_log], k
        assert float(g_state.gossip.v) == 0.0
        assert float(g_state.gossip.lr) == 1.0


def _final(d):
    d = os.path.join(d, "rank_000")
    p = os.path.join(d, f"step_{tckpt.latest_step(d):010d}")
    z = np.load(os.path.join(p, "arrays.npz"))
    with open(os.path.join(p, "manifest.json")) as f:
        return json.load(f), {k: z[k] for k in z.files}


def test_resume_equals_uninterrupted(tmp_path, capsys):
    """3 steps straight against 2, then ``--resume`` to 3: every logged
    metric and the final checkpoint, the gossip (v, lr) included, bit
    for bit."""
    cli = CLI + ["--transport", "gossip", "--topology", "exp"]
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
    assert {"state/gossip/v", "state/gossip/lr"} <= set(ms["paths"])
    leaf = {p: f"leaf_{i}" for i, p in enumerate(ms["paths"])}
    assert zs[leaf["state/gossip/lr"]] == np.float32(1.0)
    for k in zs:
        np.testing.assert_array_equal(np.atleast_1d(zs[k]).view(np.uint8),
                                      np.atleast_1d(zr[k]).view(np.uint8),
                                      err_msg=k)


def test_two_workers_resume_through_the_cli(tmp_path):
    """Two gloo workers, ``--transport gossip`` (ring(2): one neighbour):
    a resumed run equals an uninterrupted one on each rank bit for bit,
    and each rank carries its own model."""
    got = workers.spawn(workers.cli_resume, 2, CLI + [
        "--transport", "gossip"], str(tmp_path))
    for rank in range(2):
        log, first, second, a_straight, a_split, _ = got[rank]
        assert [m["step"] for m in second] == [2]
        drop = lambda lg: [{k: v for k, v in m.items()  # noqa: E731
                            if k != "step_s"} for m in lg]
        assert drop(first + second) == drop(log)
        assert sorted(a_straight) == sorted(a_split)
        for k in a_straight:
            np.testing.assert_array_equal(a_straight[k], a_split[k],
                                          err_msg=f"rank {rank} {k}")
    assert any(not np.array_equal(a, b)
               for a, b in zip(got[0][5], got[1][5]))
