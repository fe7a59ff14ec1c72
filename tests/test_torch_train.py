"""The whole slice — model, Armijo search, the gamma controller, the
bucketed and perleaf compressed exchanges, update — against the JAX
package, and the port's training CLI.

The JAX reference composes the csgd_asss path of ``worker_fn``
(src/repro/launch/train_step.py) with the model OUTSIDE any mesh, as
tests/test_distributed.py builds its reference: the LM step under a mesh
fails on this tree (ROADMAP queue 3).  Only the exchange runs in a
1-device ``shard_map``, for its collectives.  Weights come from the JAX
init through ``repro_torch.convert``; batches from both packages'
``TokenPipeline``.

Tolerances: loss and alpha within rel 1e-5, parameters and EF memory
within 1e-5 of the parameter leaf's max |p| — the forward and backward
passes sum in other orders in XLA and PyTorch, and an entry that moves by
an ulp can cross its block's threshold or its int8 rounding step.  The EF
backlog ratio is held to rel 1e-3, as it is a ratio of sums over that
memory.  Byte counts, gamma_t and the batches are exact.
"""
import functools
import gc
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import ArmijoConfig as JArmijo
from repro.core import Compressor as JCompressor
from repro.core.armijo import armijo_search as jarmijo
from repro.core.armijo import next_alpha_max as jnext_alpha_max
from repro.core.armijo import tree_sqnorm as jsqnorm
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.core.gamma import gamma_update as jgamma_update
from repro.core.telemetry import SearchTelemetry as JSearch
from repro.data.synthetic import TokenPipeline as JPipe
from repro.models import build_model
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.core.armijo import ArmijoConfig, armijo_search
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import lm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "paper-lm-100m"
SEQ, BATCH, GAMMA = 33, 4, 0.01


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _jax_step_fn(model, comp, arm, ctrl, transport):
    """One worker's csgd_asss round of the JAX package, outside a mesh:
    the search, the controller round (``worker_fn``'s), the exchange.
    ``ctx``: (alpha_prev, n_evals_ema, gamma_prev, step, last round's
    telemetry); returns the new one with the outputs."""
    mesh = jax.make_mesh((1,), ("data",))

    @jax.jit
    def step(params, mem, ctx, batch):
        alpha_prev, ema, gamma_prev, t, tel_prev = ctx

        def loss(p):
            return model.loss(p, batch)[0]
        f, grads = jax.value_and_grad(loss)(params)
        gsq = jsqnorm(grads)
        res = jarmijo(loss, params, grads, jnext_alpha_max(alpha_prev, arm),
                      arm, grad_sqnorm=gsq)
        gamma_t = jgamma_update(
            ctrl, comp, gamma_prev, t,
            search=JSearch(alpha=res.alpha, alpha_prev=alpha_prev,
                           n_evals=res.n_evals, n_evals_ema=ema),
            compression=tel_prev)
        eta = arm.scale_for(gamma_t) * res.alpha
        spec = jax.tree.map(lambda _: P(), params)
        upd, new_mem, wire, eff, tel = shard_map(
            lambda g, m, e, gt: jwca(g, m, e, comp, ("data",),
                                     stacked_mask=model.stacked_mask(params),
                                     gamma_t=gt, transport=transport),
            mesh=mesh, in_specs=(spec, spec, P(), P()),
            out_specs=(spec, spec, P(), P(), P()),
            axis_names={"data"})(grads, mem, eta, gamma_t)
        new_params = jax.tree.map(lambda p, u: p - u, params, upd)
        new_ctx = (res.alpha, 0.9 * ema + 0.1 * res.n_evals.astype(
            jnp.float32), gamma_t, t + 1, tel)
        return new_params, new_mem, new_ctx, f, wire, eff

    return step


def _assert_tree_close(jtree, ttree, ptree, what):
    """|jax - torch| <= 1e-5 * max|p| per leaf, p the parameter leaf."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            _assert_tree_close(v, ttree[k], ptree[k], f"{what}/{k}")
            continue
        a, b = np.asarray(v), ttree[k].detach().numpy()
        scale = float(np.abs(np.asarray(ptree[k])).max())
        assert np.abs(a - b).max() <= 1e-5 * scale, \
            f"{what}/{k}: {np.abs(a - b).max()} vs max|p| {scale}"


def test_token_pipeline_batches_bit_identical():
    for step in (0, 5):
        j = JPipe(vocab_size=512, seq_len=SEQ, global_batch=BATCH).batch(step)
        t = TokenPipeline(vocab_size=512, seq_len=SEQ,
                          global_batch=BATCH).batch(step)
        np.testing.assert_array_equal(np.asarray(j["tokens"]),
                                      t["tokens"].numpy())


#: (value bits, transport, gamma schedule, max_gamma): the fixed schedule
#: on the bucketed exchange, then the adaptive budget from gamma 1% to
#: 10% under each coupled schedule and the linear ramp (over 2 steps)
TRAIN_CASES = [(32, "bucketed", "fixed", 0.0), (8, "bucketed", "fixed", 0.0),
               (8, "perleaf", "linear", 0.1), (32, "perleaf", "ef-coupled",
                                                0.1),
               (8, "bucketed", "armijo-coupled", 0.1)]


@pytest.mark.parametrize(
    "value_bits,transport,schedule,max_gamma",
    [pytest.param(*c, id="-".join(map(str, c)) if c[3] else str(c[0]))
     for c in TRAIN_CASES])
def test_train_steps_match_jax(value_bits, transport, schedule, max_gamma):
    """Three DCSGD-ASSS steps of paper-lm-100m's smoke variant (2 layers,
    d_model 128) through the fused EF ops and the packed wire; gamma_t
    bit for bit, the effective bytes exact."""
    jcfg = jax_smoke_config(ARCH)
    model = build_model(jcfg)
    comp_kw = dict(gamma=GAMMA, method="block_topk", value_bits=value_bits,
                   max_gamma=max_gamma)
    ctrl_kw = dict(schedule=schedule, ramp_steps=2)
    jcomp = JCompressor(**comp_kw)
    arm = JArmijo()
    jctrl = JGammaCfg(**ctrl_kw)
    jstep = _jax_step_fn(model, jcomp, arm, jctrl, transport)
    params = model.init(jax.random.PRNGKey(0))
    mem = jax.tree.map(jnp.zeros_like, params)
    from repro.core.gamma import gamma_init as jgamma_init
    from repro.core.telemetry import CompressionTelemetry as JTel
    ctx = (jnp.float32(arm.alpha0), jnp.float32(0.0),
           jgamma_init(jctrl, jcomp), jnp.int32(0), JTel.init())

    cfg = get_smoke_config(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(SEQ, BATCH),
                    optimizer=OptimizerConfig(
                        compressor=Compressor(**comp_kw),
                        gamma_controller=GammaControllerConfig(**ctrl_kw),
                        transport=transport))
    tparams = to_torch(jax.tree.map(np.asarray, params))
    state = init_train_state(tparams, run)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=BATCH)
    for step in range(3):
        batch = pipe.batch(step)
        params, mem, ctx, loss, wire, eff = jstep(
            params, mem, ctx, {"tokens": jnp.asarray(batch["tokens"])})
        tparams, state, m = train_step(tparams, state, batch, run)
        np.testing.assert_allclose(m["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(state.alpha_prev), float(ctx[0]),
                                   rtol=1e-5)
        assert np.float32(state.gamma).view(np.int32) == \
            np.asarray(ctx[2], np.float32).view(np.int32), step
        assert (m["wire_bytes"], m["effective_wire_bytes"]) == \
            (float(wire), float(eff))
        np.testing.assert_allclose(m["ef_backlog"],
                                   float(ctx[4].ef_backlog), rtol=1e-3)
        _assert_tree_close(params, tparams, params, f"step {step} params")
        _assert_tree_close(mem, state.memory, params, f"step {step} memory")


@pytest.mark.parametrize("alpha_max", [0.05, 3.0, 50.0])
def test_armijo_search_matches_jax(alpha_max):
    """Accepted alpha, trial count and verdict of Algorithm 1, exactly, on
    a quadratic whose loss is +inf far from the start: a non-finite trial
    is a reject, and a large alpha_max backtracks through it."""
    w = np.random.default_rng(7).uniform(0.5, 1.5, 8).astype(np.float32)

    def jloss(p):
        return jnp.sum(p["w"] ** 2) + jnp.where(
            jnp.max(jnp.abs(p["w"])) > 4, jnp.inf, 0.0)

    def tloss(p):
        return (p["w"] ** 2).sum() + torch.where(
            p["w"].abs().max() > 4, torch.inf, 0.0)

    jp, tp = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    jres = jarmijo(jloss, jp, {"w": 2 * jp["w"]}, jnp.float32(alpha_max),
                   JArmijo())
    tres = armijo_search(tloss, tp, {"w": 2 * tp["w"]},
                         np.float32(alpha_max), ArmijoConfig())
    assert float(jres.alpha) == float(tres.alpha)
    assert float(jres.eta) == float(tres.eta)
    assert int(jres.n_evals) == tres.n_evals
    assert bool(jres.accepted) == tres.accepted


def test_train_step_frees_its_tensors_without_the_cycle_collector():
    """No tensor of a step sits in a reference cycle: each is freed when
    its last reference goes, not whenever Python's cycle collector runs
    (on the card, cyclic garbage holding gradients raised peak memory)."""
    cfg = get_smoke_config(ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(SEQ, BATCH),
                    optimizer=OptimizerConfig(compressor=Compressor(
                        gamma=GAMMA, method="block_topk")))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=BATCH)
    params = lm.init_params(cfg, seed=0, device=torch.device("cpu"))
    state = init_train_state(params, run)
    params, state, _ = train_step(params, state, pipe.batch(0), run)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        train_step(params, state, pipe.batch(1), run)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not cyclic, f"{len(cyclic)} tensors freed only by the collector"


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "log.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "2", "--compress-method", "block_topk",
         "--log-every", "1", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    log = json.loads(out.read_text())
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["wire_bytes"] > 0 for m in log)


def test_cli_refuses_missing_cuda(monkeypatch):
    """Without CUDA and without --device cpu the entry point raises; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.resolve_device("cuda")
    assert train_cli.resolve_device("cpu").type == "cpu"


def test_convert_round_trip():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.ones(4, np.float32)}
    back = to_numpy(to_torch(tree))
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(back["b"], tree["b"])
