"""The trainer on the encoder-decoder family: DCSGD-ASSS rounds of the
seamless-m4t-large-v2 smoke model (2 encoder and 2 decoder layers, each
batch ``tokens`` and ``src_embed`` frames from ``batch_with_aux``)
against the JAX package, on the CPU.

The rounds, at gamma 0.01 on the bucketed transport at 32-bit values,
against the jitted compositions of tests/torch_trainer_ref.py, each
round from the reference's parameters and EF memory (or client state):
2 plain rounds and 2 at ``--microbatches 2`` (``worker_fn``'s microbatch
sum, every key of the batch split, the search on the first microbatch);
the cohort's rounds are in tests/test_torch_encdec_fed_train.py (a file
of its own, so that each file's JAX reference programs compile within
40 s).  Tolerances as in tests/test_torch_kinds.py: loss and alpha rel
1e-5, parameters and EF memory within 1e-5 of the leaf's max; n_evals
and bytes exact.

JAX's registry gives the encoder-decoder ``lm.stacked_mask``, which
marks no leaf of its tree (it knows ``blocks``, ``cross`` and ``tail``):
each (layers, ...) leaf of ``enc_blocks`` / ``dec_blocks`` compresses as
ONE row, not one row a layer.  The port follows JAX (ROADMAP queue 3);
its bucket plan equals JAX's lane for lane, at the smoke size and at
full size.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_trainer_ref as ref
from repro.comm.bucket import build_bucket_plan as jax_plan
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Compressor as JCompressor
from repro.models import build_model as jax_build_model
from repro_torch.comm import exchange
from repro_torch.comm.bucket import build_bucket_plan
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.compression import Compressor
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("micro", [1, 2])
def test_dcsgd_rounds_match_jax(group, micro):
    """2 rounds, each from the reference's parameters and EF memory; at
    2 microbatches each takes 3 of the 6 rows of both keys."""
    case = ref.Case("csgd_asss", arch=ARCH, micro=micro)
    assert case.run().microbatches == micro
    tparams, state, log = ref.run_both(case, steps=2)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0
    assert tuple(tparams["dec_blocks"]["cross"]["wk"]["w"].shape) == \
        (2, 128, 128)
    assert tuple(state.memory["enc_blocks"]["mlp"]["wg"].shape) == \
        (2, 128, 256)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_bucket_plan_rows_equal_jax(size):
    """The compression rows: every leaf one row (JAX's stacked_mask marks
    none), JAX's plan lane for lane.  Full size from shapes alone (JAX's
    ``eval_shape``, the port's fake tensors): 27 leaves, each of the
    (12, ...) leaves one row."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg = jax_smoke_config(ARCH) if size == "smoke" else jax_config(ARCH)
    cfg = get_smoke_config(ARCH) if size == "smoke" else get_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jstacked = jax.tree.leaves(jm.stacked_mask(jp))
    want = jax_plan([x.shape for x in jax.tree.leaves(jp)], jstacked,
                    JCompressor(gamma=0.01, method="block_topk"))
    model = build_model(cfg)
    with FakeTensorMode():
        params = model.init(0)
        shapes = [tuple(p.shape) for p in tree_flatten(params)[0]]
        stacked = tree_flatten(model.stacked_mask(params))[0]
    assert stacked == list(jstacked) and not any(stacked)
    got = build_bucket_plan(shapes, stacked,
                            Compressor(gamma=0.01, method="block_topk"))
    assert got.total_words == want.total_words
    assert [(ln.L, ln.d, ln.dense, ln.word_off) for ln in got.leaves] == \
        [(ln.L, ln.d, ln.dense, ln.word_off) for ln in want.leaves]
    assert len(got.leaves) == 27 and {ln.L for ln in got.leaves} == {1}
    layers = {s[0] for s in shapes if len(s) > 1 and len(s) != 2}
    assert layers == {cfg.n_enc_layers} == {cfg.n_dec_layers}


def test_train_cli_runs_seamless_smoke(group):
    """The CLI on the CPU: 2 plain steps, and 2 rounds of a 2-client
    cohort; ``train.run(..., n_layers=)`` refuses an encoder-decoder."""
    base = ["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "2",
            "--compress-method", "block_topk", "--seq-len", "17",
            "--global-batch", "4", "--log-every", "1"]
    for extra in ([], ["--n-clients", "2"], ["--microbatches", "2"]):
        log = train_cli.main(base + extra)
        assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
        assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0
    with pytest.raises(ValueError, match="encoder-decoder"):
        train_cli.run(base, n_layers=1)
