"""Expert parallelism in the port (``models/moe.py``: ``moe_local``, the
mesh path of ``moe_block``) against the JAX package's ``_moe_local`` and
``moe_block``, on the CPU.

At granite-moe's smoke widths with 8 experts top-2, x (4, 16, 128) f32,
JAX jitted outside any mesh:

* each shard of the experts at M 1, 2 and 4 (``e_offset = shard *
  E/M``): the port's ``moe_local`` equals JAX's ``_moe_local`` within
  1e-5 of max|y| (tests/test_torch_moe.py's bound for ``moe_block``: the
  products sum in other orders than XLA's; a slot routed to the wrong
  expert or kept where JAX drops it moves y by far more), with slots
  dropped (capacity factor 0.5), with every probability tied (a zero
  router), and drop-free (``no_drop``);
* at one shard JAX's ``_moe_local`` IS its ``moe_block``, bit for bit
  (what its shard_map computes at a model axis of 1), and so is the
  port's;
* the shards' partial outputs added equal JAX's ``moe_block`` within
  1e-5 of max|y|;
* the capacity rule across a data axis of 2, on a 2x2 gloo mesh (4
  ranks, one spawn): ``moe_expert_parallel=False`` equals JAX's
  ``moe_block`` over the whole batch, ``True`` JAX's ``moe_block`` over
  each data half alone, both within 1e-5 of max (dropping at prefill,
  so the two differ); at decode (``no_drop``) the two agree;
* the trainer, which has no mesh, computes the same bits with the flag
  as without it (two granite smoke rounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_trainer_ref as ref
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import moe
from repro_torch.utils import tree_flatten
from torch_overlap_workers import Spawned
from torch_tp_workers import moe_capacity

torch.set_num_threads(2)

ARCH = "granite-moe-1b-a400m"
E8 = dict(n_experts=8, experts_per_token=2)
#: (id, capacity factor, no_drop, zero router: every probability tied)
CASES = [("drops", 0.5, False, False), ("tied", 0.5, False, True),
         ("no-drop", 0.5, True, False)]
SHARDS = [1, 2, 4]


def _configs(**kw):
    return (dataclasses.replace(jax_smoke_config(ARCH), **E8, **kw),
            dataclasses.replace(get_smoke_config(ARCH), **E8, **kw))


def _inputs(tied):
    jcfg, _ = _configs()
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), jcfg,
                                               jnp.float32))
    if tied:
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    x = np.random.default_rng(2).standard_normal((4, 16, 128)).astype(
        np.float32)
    return p, x


@pytest.fixture(scope="module")
def jax_shards():
    """JAX's ``_moe_local`` of every shard at every M and its
    ``moe_block``, for every case, in one jitted program."""
    runs = {}
    for name, cf, no_drop, tied in CASES:
        p, x = _inputs(tied)
        runs[name] = dict(p=p, x=x, cf=cf, no_drop=no_drop)

    @jax.jit
    def run(ps, x):
        out = {}
        for name, c in runs.items():
            jcfg, _ = _configs(capacity_factor=c["cf"])
            p = ps[name]
            out[name, 0] = jmoe.moe_block(p, x, jcfg,
                                          no_drop=c["no_drop"])[0]
            for M in SHARDS:
                n = 8 // M
                for s in range(M):
                    out[name, M, s] = jmoe._moe_local(
                        x, p["router"]["w"], p["wg"][s * n:(s + 1) * n],
                        p["wi"][s * n:(s + 1) * n],
                        p["wo"][s * n:(s + 1) * n], jcfg, e_offset=s * n,
                        no_drop=c["no_drop"])[0]
        return out

    x = runs["drops"]["x"]
    got = run({n: c["p"] for n, c in runs.items()}, jnp.asarray(x))
    return runs, {k: np.asarray(v) for k, v in got.items()}


@pytest.mark.parametrize("M", SHARDS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_moe_local_equals_jax_per_shard(jax_shards, name, M):
    runs, want = jax_shards
    c = runs[name]
    _, cfg = _configs(capacity_factor=c["cf"])
    p, x = to_torch(c["p"]), torch.from_numpy(c["x"])
    n = 8 // M
    block = want[name, 0]
    tol = 1e-5 * float(np.abs(block).max())
    total = torch.zeros_like(x)
    for s in range(M):
        y, _ = moe.moe_local(x, p["router"]["w"], p["wg"][s * n:(s + 1) * n],
                             p["wi"][s * n:(s + 1) * n],
                             p["wo"][s * n:(s + 1) * n], cfg, e_offset=s * n,
                             no_drop=c["no_drop"])
        np.testing.assert_allclose(y.numpy(), want[name, M, s], rtol=0,
                                   atol=tol)
        total = total + y
    if M == 1:
        np.testing.assert_array_equal(want[name, 1, 0], block)
        assert torch.equal(total, moe.moe_block(
            p, x, cfg, no_drop=c["no_drop"])[0])
    np.testing.assert_allclose(total.numpy(), block, rtol=0, atol=tol)
    if name == "drops":
        r = moe.route(p, x.reshape(-1, 128), cfg)
        assert not r.keep.all()


#: (id, moe_expert_parallel, no_drop) of the capacity runs
CAPACITY = [("global-prefill", False, False), ("local-prefill", True, False),
            ("global-decode", False, True), ("local-decode", True, True)]


def test_capacity_rule_across_the_data_axis():
    p, x = _inputs(False)
    cases = [(name, _configs(capacity_factor=0.5,
                             moe_expert_parallel=ep)[1], no_drop)
             for name, ep, no_drop in CAPACITY]
    spawned = Spawned(moe_capacity, 4, (2, 2), cases, p, x)
    jcfg, _ = _configs(capacity_factor=0.5)
    f = jax.jit(lambda p, x, no_drop: jmoe.moe_block(p, x, jcfg, no_drop)[0],
                static_argnums=2)
    whole = {nd: np.asarray(f(p, x, nd)) for nd in (False, True)}
    halves = {nd: np.concatenate([np.asarray(f(p, x[:2], nd)),
                                  np.asarray(f(p, x[2:], nd))])
              for nd in (False, True)}
    got = spawned.result(timeout=240)
    for (name, ep, no_drop) in CAPACITY:
        want = (halves if ep else whole)[no_drop]
        for y, (dp, _) in got.values():
            w = want[2 * dp:2 * dp + 2]
            np.testing.assert_allclose(y[name], w, rtol=0, atol=1e-5 * float(
                np.abs(w).max()), err_msg=name)
    # the test can tell the rules apart: they drop other slots at prefill
    assert np.abs(whole[False] - halves[False]).max() > 1e-3
    np.testing.assert_allclose(whole[True], halves[True], rtol=0,
                               atol=1e-5 * float(np.abs(whole[True]).max()))


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def test_trainer_with_the_flag_computes_the_same_bits(group):
    """Two DCSGD-ASSS rounds of the granite smoke (no mesh) with and
    without ``moe_expert_parallel``: parameters, EF memory and metrics
    bit for bit."""
    base = ref.Case("csgd_asss", arch=ARCH).run()
    runs = {}
    for ep in (False, True):
        run = dataclasses.replace(base, model=dataclasses.replace(
            base.model, moe_expert_parallel=ep))
        _, jparams = ref.jax_model(ARCH)
        params = to_torch(jax.tree.map(np.asarray, jparams))
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=run.model.vocab_size,
                             seq_len=ref.SEQ, global_batch=ref.BATCH)
        log = []
        for t in range(2):
            params, state, m = train_step(params, state,
                                          pipe.batch_with_aux(t, run.model),
                                          run)
            log.append(m)
        runs[ep] = (params, state.memory, log)
    (p0, m0, log0), (p1, m1, log1) = runs[False], runs[True]
    for a, b in zip(tree_flatten([p0, m0])[0], tree_flatten([p1, m1])[0]):
        assert torch.equal(a, b)
    assert [m["loss"] for m in log0] == [m["loss"] for m in log1]
    assert [m["alpha"] for m in log0] == [m["alpha"] for m in log1]
    assert all(np.isfinite(m["loss"]) for m in log0)
