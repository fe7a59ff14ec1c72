"""The MoE layer of the port (``repro_torch/models/moe.py``) against the
JAX package's ``src/repro/models/moe.py``, on the CPU, at the
granite-moe-1b-a400m smoke size (4 experts, top-2, width 64), and
DCSGD-ASSS rounds of the granite smoke model against JAX's trainer.

Inputs come from numpy seeds, the weights from JAX's ``init_moe`` (or
its model's init), carried over by ``repro_torch.convert``; JAX runs
jitted, outside any mesh.  ``moe_block`` in f32: the routes (expert ids
by descending probability, the sorted slots, their tokens and positions,
the keep mask and C) exact, y within 1e-5 of max|y|, aux within rel
1e-6.  The JAX side of the routes is moe_block's own lines
(src/repro/models/moe.py:164-187), jitted, since JAX's layer returns
only (y, aux).  Then the twins of tests/test_moe.py's checks on the
port alone, and the bf16 MoE tree through ``convert``.

The trainer: 2 DCSGD-ASSS rounds of the granite smoke at gamma 0.01 on
the bucketed transport at 32-bit values, against the jitted composition
of ``worker_fn``'s lines in tests/torch_trainer_ref.py, each round from
the reference's parameters and EF memory.  Tolerances as in
tests/test_torch_kinds.py: loss and alpha rel 1e-5, parameters and EF
memory within 1e-5 of the leaf's max; n_evals and bytes exact.
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
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_torch
from repro_torch.launch import train as train_cli
from repro_torch.models import moe

torch.set_num_threads(2)

ARCH = "granite-moe-1b-a400m"
f32 = np.float32


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _configs(**kw):
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _jax_route(p, x, cfg, no_drop):
    """moe_block's routing lines (src/repro/models/moe.py:159-187)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    logits = (xt.astype(jnp.float32) @ p["router"]["w"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, eids = jax.lax.top_k(probs, k)
    C = T if no_drop else min(T, max(1, int(-(-T * k // E)
                                            * cfg.capacity_factor)))
    flat_e = eids.reshape(-1)
    tok_id = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e)
    se, st = flat_e[order], tok_id[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * k) - starts[se]
    return dict(probs=probs, eids=eids, se=se, st=st, pos=pos,
                keep=pos < C), C


#: (id, capacity factor, no_drop, zero router: every probability tied)
CASES = [("drop-free", 2.0, False, False), ("drops", 0.25, False, False),
         ("no-drop", 0.25, True, False), ("tied", 0.25, False, True)]


@pytest.fixture(scope="module")
def jax_moe_results():
    """JAX's (y, aux) and routes of every case, in one jitted program."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 128)).astype(f32)
    out = {}
    for name, cf, no_drop, tied in CASES:
        jcfg, _ = _configs(capacity_factor=cf)
        p = jax.tree.map(np.asarray, jmoe.init_moe(
            jax.random.PRNGKey(1), jcfg, jnp.float32))
        if tied:
            p["router"]["w"] = np.zeros_like(p["router"]["w"])
        out[name] = dict(p=p, x=x, jcfg=jcfg, no_drop=no_drop)

    @jax.jit
    def run(ps, x):
        res = {}
        for name, c in out.items():
            y, aux = jmoe.moe_block(ps[name], x, c["jcfg"],
                                    no_drop=c["no_drop"])
            routes, c["C"] = _jax_route(ps[name], x, c["jcfg"],
                                        c["no_drop"])
            res[name] = (y, aux, routes)
        return res

    got = run({n: c["p"] for n, c in out.items()}, jnp.asarray(x))
    for name, c in out.items():
        y, aux, routes = got[name]
        c.update(y=np.asarray(y), aux=np.asarray(aux),
                 routes=jax.tree.map(np.asarray, routes))
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_moe_block_matches_jax(jax_moe_results, name):
    c = jax_moe_results[name]
    _, cfg = _configs(capacity_factor=c["jcfg"].capacity_factor)
    p, x = to_torch(c["p"]), torch.from_numpy(c["x"])
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg, c["no_drop"])
    want = c["routes"]
    gap = np.sort(want["probs"], -1)[:, ::-1]
    gap = float((gap[:, cfg.experts_per_token - 1]
                 - gap[:, cfg.experts_per_token]).min())
    assert r.C == c["C"]
    for f in ("eids", "se", "st", "pos", "keep"):
        np.testing.assert_array_equal(getattr(r, f).numpy(), want[f],
                                      err_msg=f"{f} (least top-k gap {gap})")
    if name == "tied":
        # JAX's top_k puts the lower id first among equal probabilities
        assert (r.eids.numpy() == np.arange(2)).all()
        assert int(r.keep.sum()) == 2 * r.C
    if name == "drops":
        assert not r.keep.all()
    y, aux = moe.moe_block(p, x, cfg, no_drop=c["no_drop"])
    np.testing.assert_allclose(y.numpy(), c["y"], rtol=0,
                               atol=1e-5 * float(np.abs(c["y"]).max()))
    np.testing.assert_allclose(float(aux), float(c["aux"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# twins of tests/test_moe.py, on the port alone
# ---------------------------------------------------------------------------

def _init(cfg, seed=0):
    return moe.init_moe(torch.Generator().manual_seed(seed), cfg,
                        torch.float32)


def _x(shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_moe_output_shape_and_finite():
    _, cfg = _configs()
    x = _x((2, 16, cfg.d_model))
    y, aux = moe.moe_block(_init(cfg), x, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux) >= 0.0


def test_moe_grad_flows_to_all_parts():
    _, cfg = _configs()
    p = {k: (v.requires_grad_() if isinstance(v, torch.Tensor) else
             {kk: vv.requires_grad_() for kk, vv in v.items()})
         for k, v in _init(cfg).items()}
    y, aux = moe.moe_block(p, _x((2, 16, cfg.d_model)), cfg)
    (y.square().sum() + aux).backward()
    for leaf in (p["router"]["w"], p["wg"], p["wi"], p["wo"]):
        assert float(leaf.grad.abs().sum()) > 0


def test_capacity_dropping():
    """A capacity factor of 0.25 drops tokens (combine weight 0); the
    result stays finite and differs from the drop-free one."""
    _, small = _configs(capacity_factor=0.25)
    p, x = _init(small), _x((2, 32, small.d_model))
    y, _ = moe.moe_block(p, x, small)
    assert torch.isfinite(y).all()
    y_nodrop, _ = moe.moe_block(p, x, small, no_drop=True)
    assert float((y - y_nodrop).abs().max()) > 1e-6


def test_no_drop_mode_exact_topk_mixture():
    """E = 2, k = 2, no_drop: the layer is the probability-weighted sum
    of both experts' MLPs."""
    _, cfg = _configs(n_experts=2, experts_per_token=2)
    p, x = _init(cfg), _x((1, 8, cfg.d_model))
    y, _ = moe.moe_block(p, x, cfg, no_drop=True)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    oracle = sum(probs[:, e:e + 1] * ((torch.nn.functional.silu(
        xt @ p["wg"][e]) * (xt @ p["wi"][e])) @ p["wo"][e])
        for e in range(2))
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               oracle.numpy(), atol=1e-4)


def test_aux_loss_balanced_vs_collapsed():
    """The balance loss is ~1 (coef 1) for a uniform router and E for a
    collapsed one."""
    E, T = 4, 4096
    aux_u = float(moe.balance_loss(torch.full((T, E), 1.0 / E),
                                   torch.arange(T) % E, 1.0))
    collapsed = torch.zeros((T, E))
    collapsed[:, 0] = 1.0
    aux_c = float(moe.balance_loss(collapsed, torch.zeros(T, dtype=torch.long),
                                   1.0))
    assert aux_u == pytest.approx(1.0, rel=0.05)
    assert aux_c == pytest.approx(E, rel=0.05)
    assert aux_c > aux_u


def test_bf16_moe_params_convert_bit_for_bit():
    """The granite smoke tree in bf16: the f32 router stays f32, the
    experts and every other leaf carry their 16-bit patterns."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(5)))
    got = to_torch(tree)
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape
        if w.dtype == np.float32:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
    blk = got["blocks"]["moe"]
    assert blk["router"]["w"].dtype == torch.float32
    assert tuple(blk["wg"].shape) == (2, 4, 128, 64)
    assert blk["wo"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the trainer: DCSGD-ASSS rounds of the granite smoke against JAX
# ---------------------------------------------------------------------------

def test_dcsgd_rounds_match_jax(group):
    """2 rounds, each from the reference's parameters and EF memory; the
    MoE leaves are per-layer rows of the bucketed exchange."""
    case = ref.Case("csgd_asss", arch=ARCH)
    tparams, state, log = ref.run_both(case, steps=2)
    assert [m["n_evals"] for m in log] and all(
        np.isfinite(m["loss"]) for m in log)
    assert tuple(tparams["blocks"]["moe"]["wg"].shape) == (2, 4, 128, 64)
    assert state.memory["blocks"]["moe"]["router"]["w"].dtype == \
        torch.float32


def test_train_cli_runs_granite_smoke(group):
    log = train_cli.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                          "--steps", "2", "--compress-method", "block_topk",
                          "--seq-len", "33", "--global-batch", "4"])
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    assert log[0]["wire_bytes"] == log[1]["wire_bytes"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_armijo_candidate_follows_jax_promotion(dtype):
    """The search's candidate p - a*g as JAX's ``_tree_axpy`` computes it
    under jit with an f32 ``a``: a bf16 leaf comes back f32, an f32 leaf
    stays f32; the same bits either way."""
    from repro.core.armijo import _tree_axpy
    from repro_torch.core.armijo import _candidate
    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.standard_normal((64, 96)), dtype)
    g = jnp.asarray(rng.standard_normal((64, 96)), dtype)
    a = jnp.float32(0.0345)
    want = jax.jit(_tree_axpy)(a, g, p)
    got = _candidate(to_torch(np.asarray(p)), to_torch(np.asarray(g)),
                     float(a))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
