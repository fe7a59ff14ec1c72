"""The trainer on the vlm family: DCSGD-ASSS rounds of the
llama-3.2-vision-11b smoke model (4 dense layers in 2 groups, each
followed by a gated cross-attention block into 16 patches; each batch's
``tokens`` and ``image_embed`` from ``batch_with_aux``) against the JAX
package, on the CPU.

The rounds, at gamma 0.01 on the bucketed transport at 32-bit values,
against the jitted composition of tests/torch_trainer_ref.py, each round
from the reference's parameters and EF memory, both packages started
from JAX's initial weights with the gates drawn in [0.5, 1)
(``jax_model``: at 0 the cross blocks would take no part in the loss
and get an exact-zero gradient).  Tolerances as in
tests/test_torch_kinds.py: loss and alpha rel 1e-5, parameters and EF
memory within 1e-5 of the leaf's max; n_evals and bytes exact.

JAX's ``stacked_mask`` marks every leaf under ``blocks`` and ``cross``:
a (groups, every, ...) leaf is one row a group, a (groups, ...) cross
leaf one row a group; JAX's plan takes a marked leaf of one axis, each
(groups,) f32 gate, as ONE row of ``groups`` elements.  The port's
bucket plan equals JAX's lane for lane, at the smoke size and at full
width on one group (``n_layers`` 5, the depth the trainer runs at on the
card).
"""
import dataclasses

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

ARCH = "llama-3.2-vision-11b"


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def test_dcsgd_rounds_match_jax(group):
    """2 rounds, each from the reference's parameters and EF memory, with
    live gates: the cross blocks' EF memory is non-zero after a round."""
    case = ref.Case("csgd_asss", arch=ARCH)
    _, jparams = ref.jax_model(ARCH)
    assert np.all(np.asarray(jparams["cross"]["gate_attn"]) >= 0.5)
    tparams, state, log = ref.run_both(case, steps=2)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0
    assert tuple(tparams["blocks"]["mlp"]["wg"].shape) == (2, 2, 128, 256)
    assert tuple(tparams["cross"]["cross"]["wk"]["w"].shape) == (2, 128, 128)
    assert tparams["cross"]["gate_mlp"].dtype == torch.float32
    assert state.memory["cross"]["cross"]["wk"]["w"].abs().max() > 0


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_bucket_plan_rows_equal_jax(size):
    """The compression rows: one a group for every ``blocks`` and
    ``cross`` leaf but the gates (each one row of ``groups`` elements),
    one a leaf for the rest; JAX's plan lane for lane.  Full width at one
    group (``n_layers`` 5) from shapes alone (JAX's ``eval_shape``, the
    port's fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if size == "smoke":
        jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    else:
        jcfg = dataclasses.replace(jax_config(ARCH), n_layers=5)
        cfg = train_cli.cut_depth(get_config(ARCH), 5)
    groups = cfg.n_layers // cfg.cross_attn_every
    jm = jax_build_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jstacked = jax.tree.leaves(jm.stacked_mask(jp))
    comp = dict(gamma=0.01, method="block_topk")
    want = jax_plan([x.shape for x in jax.tree.leaves(jp)], jstacked,
                    JCompressor(**comp))
    model = build_model(cfg)
    with FakeTensorMode():
        params = model.init(0)
        shapes = [tuple(p.shape) for p in tree_flatten(params)[0]]
        stacked = tree_flatten(model.stacked_mask(params))[0]
    assert stacked == list(jstacked)
    got = build_bucket_plan(shapes, stacked, Compressor(**comp))
    assert got.total_words == want.total_words
    assert [(ln.L, ln.d, ln.dense, ln.word_off) for ln in got.leaves] == \
        [(ln.L, ln.d, ln.dense, ln.word_off) for ln in want.leaves]
    assert [(b.index_bits, b.leaf_ids) for b in got.buckets] == \
        [(b.index_bits, b.leaf_ids) for b in want.buckets]
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    rows = {tuple(k.key for k in p): (ln.L, ln.d)
            for p, ln in zip(paths, got.leaves)}
    # a stacked leaf of one axis is one row (JAX's plan_geometry)
    for gate in ("gate_attn", "gate_mlp"):
        assert rows[("cross", gate)] == (1, groups)
    assert {L for p, (L, _) in rows.items() if p[0] in ("blocks", "cross")
            and p[-1] not in ("gate_attn", "gate_mlp")} == {groups}
    assert {L for p, (L, _) in rows.items()
            if p[0] not in ("blocks", "cross")} == {1}


def test_train_cli_runs_vlm_smoke(group):
    """The CLI on the CPU: 2 steps; ``train.run(..., n_layers=2)`` keeps
    one group, and a depth of 3 (not a whole group) raises."""
    base = ["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "2",
            "--compress-method", "block_topk", "--seq-len", "17",
            "--global-batch", "4", "--log-every", "1"]
    log = train_cli.main(base)
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0
    log, params, _ = train_cli.run(base, n_layers=2)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tuple(params["blocks"]["attn_norm"]["w"].shape) == (1, 2, 128)
    assert tuple(params["cross"]["gate_attn"].shape) == (1,)
    with pytest.raises(ValueError, match="cross_attn_every"):
        train_cli.run(base, n_layers=3)
