"""The trainer's runtime on the overlap transport: the local-steps round
(``--local-steps 2``) against the JAX package's ``_local_steps_worker``
with its overlap seam (3 rounds at delay 0 and 1, ``csgd_asss`` and
``nonadaptive``, as tests/test_torch_overlap_train.py holds the plain
round); a skipped step keeps the carried state; a resume at delay 1
equals an uninterrupted run; the CLI's flags and refusals; two gloo
workers through the CLI.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.comm import exchange
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_step as ts
from repro_torch.models import lm

import torch_overlap_workers as workers
import torch_trainer_ref as ref

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ref.overlap_cases(2), ids=ref.case_id)
def test_overlap_local_steps_rounds_match_jax(case):
    ref.check_overlap_rounds(case)


@pytest.mark.parametrize("delay", [0, 1])
def test_skipped_step_keeps_the_overlap_state(delay):
    """``nonadaptive`` rounds at eta 0.1, inf, 0.1 under the breaker.  At
    delay 0 the inf round's own aggregate is non-finite and that round
    is skipped; at delay 1 it applies the finite carried aggregate and
    carries the non-finite payload, which the next round applies and is
    skipped for.  The skipped round keeps the parameters, the EF memory
    and the carried state it was handed, as JAX's frozen state does."""
    runs = [ref.overlap_run(delay, kind="nonadaptive", eta=eta)
            for eta in (0.1, float("inf"), 0.1)]
    params = lm.init_params(runs[0].model, seed=0)
    state = ts.init_train_state(params, runs[0])
    pipe = TokenPipeline(vocab_size=runs[0].model.vocab_size,
                         seq_len=ref.SEQ, global_batch=ref.BATCH)
    skipped = []
    for t, run in enumerate(runs):
        new_params, new_state, m = ts.train_step(params, state,
                                                 pipe.batch(t), run)
        skipped.append(m["consecutive_skips"])
        assert m["staleness"] == (delay if t else 0.0)
        if skipped[-1]:
            assert new_state.overlap is state.overlap
            assert new_state.memory is state.memory
            ref.assert_bitwise_equal(new_params, params)
            assert new_state.step == state.step + 1
            break
        params, state = new_params, new_state
    assert skipped == ([0.0, 1.0] if delay == 0 else [0.0, 0.0, 1.0])


CLI = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
       "4", "--compress-method", "block_topk", "--log-every", "1",
       "--transport", "overlap", "--overlap-chunks", "3"]


def _final(d):
    d = os.path.join(d, "rank_000")
    p = os.path.join(d, f"step_{tckpt.latest_step(d):010d}")
    z = np.load(os.path.join(p, "arrays.npz"))
    with open(os.path.join(p, "manifest.json")) as f:
        return json.load(f), {k: z[k] for k in z.files}


def test_resume_at_delay1_equals_uninterrupted(tmp_path, capsys):
    """4 steps straight against 2, then ``--resume`` to 4: every logged
    metric and the final checkpoint — the carried payload, dense buffer,
    effective bytes and ``seeded`` included — bit for bit; the resumed
    step 2 applies the carried step-1 payload."""
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    log = train_cli.main(CLI + ["--steps", "4", "--ckpt-dir", straight])
    first = train_cli.main(CLI + ["--steps", "2", "--ckpt-dir", split,
                                  "--ckpt-every", "1"])
    capsys.readouterr()
    second, _, state = train_cli.run(CLI + ["--steps", "4", "--ckpt-dir",
                                            split, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "stale=1" in out
    strip = lambda lg: [{k: v for k, v in m.items() if k != "step_s"}  # noqa
                        for m in lg]
    assert strip(first + second) == strip(log)
    assert [m["staleness"] for m in log] == [0.0, 1.0, 1.0, 1.0]
    (ms, zs), (mr, zr) = _final(straight), _final(split)
    assert ms == mr
    assert {"state/overlap/payload", "state/overlap/dense",
            "state/overlap/eff_wire", "state/overlap/seeded"} <= \
        set(ms["paths"])
    leaf = {p: f"leaf_{i}" for i, p in enumerate(ms["paths"])}
    pay = zs[leaf["state/overlap/payload"]]
    assert pay.dtype == np.int32 and pay.any()
    assert pay.size == state.overlap.payload.numel()
    assert zs[leaf["state/overlap/seeded"]] == np.float32(1.0)
    for k in zs:
        np.testing.assert_array_equal(np.atleast_1d(zs[k]).view(np.uint8),
                                      np.atleast_1d(zr[k]).view(np.uint8),
                                      err_msg=k)


def test_cli_refuses_as_jax_does():
    for extra, match in ((["--opt", "acgd"], "needs a compressing"),
                         (["--opt", "sls"], "needs a compressing"),
                         (["--downlink", "compressed"], "never materializes")):
        with pytest.raises(ValueError, match=match):
            train_cli.main(CLI + ["--steps", "1"] + extra)
    with pytest.raises(SystemExit):
        train_cli.parse_args(CLI + ["--overlap-delay", "2"])
    with pytest.raises(ValueError, match="overlap n_chunks must be >= 1"):
        train_cli.main(CLI + ["--steps", "1", "--overlap-chunks", "0"])
    args = train_cli.parse_args([])
    assert (args.overlap_chunks, args.overlap_delay) == (1, 1)
    assert OptimizerConfig().overlap == OptimizerConfig(
        transport="overlap").overlap


def test_two_workers_through_the_cli(tmp_path):
    """Two gloo workers, ``--transport overlap`` at delay 1 over a 3-chunk
    ring: a resumed run equals an uninterrupted one on each rank bit for
    bit, the ranks hold the same parameters (one decoded mean), their
    own carried payloads, and ``staleness`` 0, 1, 1."""
    got = workers.spawn(workers.cli_resume, 2, CLI, str(tmp_path))
    for rank in range(2):
        log, first, second, a_straight, a_split, _ = got[rank]
        assert [m["step"] for m in second] == [2]
        drop = lambda lg: [{k: v for k, v in m.items()  # noqa: E731
                            if k != "step_s"} for m in lg]
        assert drop(first + second) == drop(log)
        assert [m["staleness"] for m in log] == [0.0, 1.0, 1.0]
        assert sorted(a_straight) == sorted(a_split)
        for k in a_straight:
            np.testing.assert_array_equal(a_straight[k], a_split[k],
                                          err_msg=f"rank {rank} {k}")
    for i, (a, b) in enumerate(zip(got[0][5], got[1][5])):
        np.testing.assert_array_equal(a, b, err_msg=f"parameter leaf {i}")
    # leaf_41: the carried payload (after 39 parameter, EF and telemetry
    # leaves and the two empty optional states); each rank carries its own
    assert not np.array_equal(got[0][3]["leaf_41"], got[1][3]["leaf_41"])
