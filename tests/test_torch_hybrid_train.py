"""The trainer on the hybrid family: DCSGD-ASSS rounds of the zamba2-7b
smoke model (5 layers: 2 groups of 2 Mamba2 layers with the shared
attention block after each, and 1 tail layer) against the JAX package,
on the CPU.

The rounds: 2 at gamma 0.01 on the bucketed transport at 32-bit values,
against the jitted composition of ``worker_fn``'s lines in
tests/torch_trainer_ref.py, each round from the reference's parameters
and EF memory.  Tolerances as in tests/test_torch_kinds.py: loss and
alpha rel 1e-5, parameters and EF memory within 1e-5 of the leaf's max;
n_evals and bytes exact.  The hybrid's ``blocks`` leaves are stacked
(groups, every, ...), so one compression row holds a whole group, as
JAX's ``leaf_2d`` takes ``shape[0]``; its ``tail`` leaves are per-layer
rows and the shared block's leaves one row each: the port's bucket plan
equals JAX's lane for lane.  The bf16 tree (with ``A_log``, ``D_skip``
and ``dt_bias`` f32) carries over bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_trainer_ref as ref
from repro.comm.bucket import build_bucket_plan as jax_plan
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Compressor as JCompressor
from repro.models import build_model as jax_build_model
from repro_torch.comm import exchange
from repro_torch.comm.bucket import build_bucket_plan
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

ARCH = "zamba2-7b"
F32_LEAVES = ("A_log", "D_skip", "dt_bias")


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def test_dcsgd_rounds_match_jax(group):
    """2 rounds, each from the reference's parameters and EF memory."""
    case = ref.Case("csgd_asss", arch=ARCH)
    tparams, state, log = ref.run_both(case, steps=2)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0
    assert tuple(tparams["blocks"]["mamba"]["in_proj"]["w"].shape) == \
        (2, 2, 128, 552)
    assert tuple(tparams["tail"]["mamba"]["conv_w"].shape) == (1, 4, 288)
    assert tuple(state.memory["shared"]["attn"]["wq"]["w"].shape) == \
        (128, 128)


def test_bucket_plan_rows_equal_jax():
    """The compression rows of the smoke tree: one row a group for the
    (groups, every, ...) leaves, one a layer for the tail, one a leaf
    for the shared block and the rest; JAX's plan lane for lane."""
    jm = jax_build_model(jax_smoke_config(ARCH))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jflat = jax.tree.leaves(jp)
    jstacked = jax.tree.leaves(jm.stacked_mask(jp))
    want = jax_plan([x.shape for x in jflat], jstacked,
                    JCompressor(gamma=0.01, method="block_topk"))
    model = build_model(get_smoke_config(ARCH))
    params = model.init(0)
    leaves, _ = tree_flatten(params)
    stacked = tree_flatten(model.stacked_mask(params))[0]
    assert stacked == list(jstacked)
    got = build_bucket_plan([tuple(p.shape) for p in leaves], stacked,
                            Compressor(gamma=0.01, method="block_topk"))
    assert got.total_words == want.total_words
    assert [(ln.L, ln.d, ln.dense, ln.word_off) for ln in got.leaves] == \
        [(ln.L, ln.d, ln.dense, ln.word_off) for ln in want.leaves]
    rows = {path: ln.L for path, ln in zip(
        [p for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]],
        got.leaves)}
    blocks = [L for p, L in rows.items() if p[0].key == "blocks"]
    tail = [L for p, L in rows.items() if p[0].key == "tail"]
    shared = [L for p, L in rows.items() if p[0].key == "shared"]
    assert set(blocks) == {2} and set(tail) == {1} and set(shared) == {1}
    assert len(blocks) == len(tail) == len(shared) == 9


def test_bf16_hybrid_params_convert_bit_for_bit():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(5)))
    got = to_torch(tree)
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (path, w), g in zip(paths, tree_flatten(got)[0]):
        assert tuple(g.shape) == w.shape, path
        if path[-1].key in F32_LEAVES:
            assert w.dtype == np.float32 and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert w.dtype.name == "bfloat16" and g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
    # the port's own init takes the same dtypes
    mine = build_model(dataclasses.replace(
        get_smoke_config(ARCH), param_dtype="bfloat16",
        compute_dtype="bfloat16")).init(0)
    for (path, w), g in zip(paths, tree_flatten(mine)[0]):
        assert tuple(g.shape) == w.shape and \
            str(g.dtype).removeprefix("torch.") == w.dtype.name, path


def test_train_cli_runs_zamba2_smoke(group):
    log = train_cli.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                          "--steps", "2", "--compress-method", "block_topk",
                          "--seq-len", "33", "--global-batch", "4"])
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0


def test_train_run_cuts_depth(group):
    """``train.run(..., n_layers=3)``: one group of 2 and one tail layer,
    the widths the config's."""
    _, params, _ = train_cli.run(
        ["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "1",
         "--compress-method", "block_topk", "--seq-len", "17",
         "--global-batch", "2"], n_layers=3)
    assert tuple(params["blocks"]["norm"]["w"].shape) == (1, 2, 128)
    assert tuple(params["tail"]["norm"]["w"].shape) == (1, 128)
