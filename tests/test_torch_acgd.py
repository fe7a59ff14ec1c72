"""ACGD of the port against the JAX package: single-node ``ACGD.step``
(``core/acgd.py``), the roundings of its momentum lines, its config
errors, the twins of tests/test_acgd.py's two golden claims, and the
trainer's ``kind="acgd"`` (its rounds, its breaker, its CLI flags).

Single-node ACGD runs the smoke LM (2 layers, d_model 128) through both
packages, JAX's jitted as its callers run it, for 3 steps; each step
starts the port from the reference's parameters, EF memory and velocity
(the near-tie rule of ROADMAP queue 3).  Tolerances: loss rel 1e-5;
parameters, EF memory and velocity within 1e-5 of the parameter leaf's
max |p| (bf16 memory: plus the cast's one bf16 ulp where the two f32
residuals straddle a rounding midpoint, in at most one entry in 1,000);
gamma_t, the byte counts and ``cum_eff_bytes`` exact; telemetry ratios
rel 1e-4.  The trainer against the reference round of
tests/torch_trainer_ref.py, at the tolerances stated there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import Compressor as JCompressor
from repro.core.acgd import AcgdConfig as JAcgdConfig
from repro.core.acgd import acgd as jacgd
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core import ACGD, AcgdAux, AcgdConfig, AcgdState, acgd
from repro_torch.core.acgd import nesterov
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.csgd import CSGDConfig, csgd_asss
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.data import synthetic as syn
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import lm
from repro_torch.utils import tree_leaves

import torch_trainer_ref as ref

torch.set_num_threads(2)

f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the momentum lines round once, as jitted XLA contracts them
# ---------------------------------------------------------------------------

def test_momentum_lines_round_once_like_jitted_jax():
    """``v' = mu*v + g`` and ``d = mu*v' + g`` as ``worker_fn`` and
    ``ACGD.step`` write them, jitted: XLA contracts each into a fused
    multiply-add; ``nesterov`` gives the same bits.  Two roundings differ
    in a quarter of the entries."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((64, 1024)).astype(f32)
    g = rng.standard_normal((64, 1024)).astype(f32)
    mu = 0.9

    @jax.jit
    def lines(vel, grads):
        new = jax.tree.map(lambda a, b: mu * a + b.astype(jnp.float32),
                           vel, grads)
        return new, jax.tree.map(lambda a, b: mu * a + b.astype(jnp.float32),
                                 new, grads)

    jv, jd = lines({"w": jnp.asarray(v)}, {"w": jnp.asarray(g)})
    tv, td = nesterov({"w": torch.from_numpy(v)}, {"w": torch.from_numpy(g)},
                      mu)
    np.testing.assert_array_equal(tv["w"].numpy().view(np.int32),
                                  np.asarray(jv["w"]).view(np.int32))
    np.testing.assert_array_equal(td["w"].numpy().view(np.int32),
                                  np.asarray(jd["w"]).view(np.int32))
    assert (f32(mu) * v + g != np.asarray(jv["w"])).mean() > 0.2


# ---------------------------------------------------------------------------
# single-node ACGD on the smoke LM, 3 steps
# ---------------------------------------------------------------------------

#: topk, block_topk (the block_stats / threshold_split kernel path), and
#: an adaptive 10% budget under the linear ramp with bf16 EF memory
SINGLE = [
    dict(comp=dict(gamma=0.01, method="topk")),
    dict(comp=dict(gamma=0.01, method="block_topk")),
    dict(comp=dict(gamma=0.04, method="block_topk", max_gamma=0.1),
         ctrl=dict(schedule="linear", ramp_steps=2), ef_dtype="bfloat16"),
]


def _leaf_check(a, b, scale, what, bf16=False):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bad = np.abs(a - b) > 1e-5 * scale
    if bf16:
        # one bf16 ulp of the residual where the f32 values straddle a
        # rounding midpoint
        ulp = np.abs(a) * 2.0 ** -7
        assert np.all(np.abs(a - b)[bad] <= ulp[bad]), what
        assert bad.mean() <= 1e-3, f"{what}: {bad.sum()} entries"
    else:
        assert not bad.any(), \
            f"{what}: {np.abs(a - b).max()} vs max|p| {scale}"


def _check_tree(jtree, ttree, ptree, what, bf16=False):
    for k, v in jtree.items():
        if isinstance(v, dict):
            _check_tree(v, ttree[k], ptree[k], f"{what}/{k}", bf16)
            continue
        _leaf_check(v, ttree[k].detach().float().numpy(),
                    float(np.abs(np.asarray(ptree[k])).max()),
                    f"{what}/{k}", bf16)


@pytest.mark.parametrize("kw", SINGLE, ids=["topk", "block_topk",
                                            "adaptive-linear-bf16-ef"])
def test_acgd_steps_match_jax(kw):
    model, params = ref.jax_model()
    cfg = get_smoke_config(ref.ARCH)
    ctrl = kw.get("ctrl", {})
    ef_dtype = kw.get("ef_dtype", "float32")
    jopt = jacgd(JAcgdConfig(compressor=JCompressor(**kw["comp"]),
                             gamma_ctrl=JGammaCfg(**ctrl), eta=0.1,
                             momentum=0.9, ef_dtype=ef_dtype))
    topt = acgd(AcgdConfig(compressor=Compressor(**kw["comp"]),
                           gamma_ctrl=GammaControllerConfig(**ctrl),
                           eta=0.1, momentum=0.9, ef_dtype=ef_dtype))

    @jax.jit
    def jstep(p, s, tokens):
        return jopt.step(lambda q: model.loss(q, {"tokens": tokens})[0],
                         p, s)

    js = jopt.init(params)
    ts = topt.init(to_torch(jax.tree.map(np.asarray, params)))
    assert isinstance(ts, AcgdState) and ts.gamma == f32(np.asarray(js.gamma))
    assert all(v.dtype == torch.float32 for v in tree_leaves(ts.velocity))
    assert all(m.dtype == getattr(torch, ef_dtype)
               for m in tree_leaves(ts.memory))
    pipe = syn.TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                             global_batch=4)
    bf16 = ef_dtype == "bfloat16"
    for step in range(3):
        batch = pipe.batch(step)
        # from the reference's state, the port's own host scalars
        tparams = to_torch(jax.tree.map(np.asarray, params))
        ts = ts._replace(
            memory=to_torch(jax.tree.map(np.asarray, js.memory)),
            velocity=to_torch(jax.tree.map(np.asarray, js.velocity)))
        params, js, ja = jstep(params, js, jnp.asarray(batch["tokens"]))
        tparams, ts, ta = topt.step(lambda p: lm.loss_fn(p, batch, cfg),
                                    tparams, ts)
        assert isinstance(ta, AcgdAux)
        np.testing.assert_allclose(float(ta.loss), float(ja.loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(ta.grad_sqnorm),
                                   float(ja.grad_sqnorm), rtol=1e-4)
        assert ta.eta == f32(np.asarray(ja.eta)) == f32(0.1)
        assert f32(ta.gamma).view(np.int32) == \
            np.asarray(ja.gamma, np.float32).view(np.int32), step
        assert (ta.wire_bytes, ta.eff_wire_bytes, ta.cum_eff_bytes) == \
            tuple(f32(np.asarray(x)) for x in (
                ja.wire_bytes, ja.eff_wire_bytes, ja.cum_eff_bytes)), step
        assert ts.step == int(js.step) == step + 1
        for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
            np.testing.assert_allclose(float(getattr(ta.telemetry, f)),
                                       float(getattr(ja.telemetry, f)),
                                       rtol=1e-4, err_msg=f)
        _check_tree(params, tparams, params, f"step {step} params")
        _check_tree(js.velocity, ts.velocity, params, f"step {step} vel")
        _check_tree(js.memory, ts.memory, params, f"step {step} memory",
                    bf16)
    if kw["comp"].get("max_gamma"):
        assert float(ta.eff_wire_bytes) == float(ta.wire_bytes)  # at 0.1
        assert float(ts.cum_eff_bytes) < 3 * float(ta.wire_bytes)


def test_telemetry_takes_the_raw_gradient():
    """Single-node ACGD's telemetry: ``g_sq`` and ``own_dot_g`` over the
    raw gradient g, acc built from the Nesterov direction d (JAX's
    core/acgd.py:137-141).  One step from zero state: the backlog is
    ||m'|| / ||g||, not / ||d||."""
    w = torch.linspace(-1.0, 1.0, 4096)
    opt = acgd(AcgdConfig(compressor=Compressor(gamma=0.05), eta=0.1,
                          momentum=0.5))
    _, st, aux = opt.step(lambda p: 0.5 * (p * p).sum(), w, opt.init(w))
    g = w                                   # the gradient of 0.5 ||w||^2
    resid = st.memory.float()
    want = torch.sqrt((resid * resid).sum() / ((g * g).sum() + 1e-30))
    assert torch.allclose(aux.telemetry.ef_backlog, want, rtol=1e-6)
    d = 1.5 * g                             # mu*g + g from zero velocity
    assert not torch.allclose(
        aux.telemetry.ef_backlog,
        torch.sqrt((resid * resid).sum() / (d * d).sum()), rtol=1e-3)


# ---------------------------------------------------------------------------
# the config and the trainer's errors, word for word
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(momentum=-0.1), dict(momentum=1.0), dict(momentum=1.5),
    dict(gamma_ctrl="armijo-coupled")], ids=str)
def test_acgd_config_errors_match_jax(kw):
    def err(cfg_cls, gamma_cls):
        k = dict(kw)
        if "gamma_ctrl" in k:
            k["gamma_ctrl"] = gamma_cls(schedule=k["gamma_ctrl"])
        with pytest.raises(ValueError) as e:
            cfg_cls(**k)
        return str(e.value)
    assert err(AcgdConfig, GammaControllerConfig) == \
        err(JAcgdConfig, JGammaCfg)


def test_acgd_config_band_edges_and_ef_dtype():
    assert AcgdConfig(momentum=0.0).momentum == 0.0
    assert AcgdConfig(momentum=0.99).replace(eta=0.5).eta == 0.5
    AcgdConfig(compressor=Compressor(gamma=0.02, max_gamma=0.08),
               gamma_ctrl=GammaControllerConfig(schedule="ef-coupled"))
    with pytest.raises(ValueError, match="ef_dtype"):
        AcgdConfig(ef_dtype="int8")
    assert isinstance(acgd(), ACGD) and acgd().cfg == AcgdConfig()


@pytest.mark.parametrize("kw,micro", [
    (dict(kind="acgd", local_steps=2), 2),
    (dict(kind="acgd", local_steps=3), 1),
    (dict(kind="acgd", gamma_controller="armijo-coupled"), 1)],
    ids=["local-steps-2", "local-steps-3", "armijo-coupled"])
def test_trainer_errors_match_jax(kw, micro):
    def kwargs(gamma_cls, comp_cls):
        k = dict(kw, compressor=comp_cls(max_gamma=0.1))
        if "gamma_controller" in k:
            k["gamma_controller"] = gamma_cls(schedule=k["gamma_controller"])
        return k
    with pytest.raises(ValueError) as want:
        jrun = JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro,
            optimizer=JOptimizerConfig(**kwargs(JGammaCfg, JCompressor)))
        jbuild_train_step(None, jrun, jax.make_mesh((1,), ("data",)))
    with pytest.raises(ValueError) as got:
        RunConfig(model=get_smoke_config(ref.ARCH),
                  shape=ShapeConfig(ref.SEQ, ref.BATCH), microbatches=micro,
                  optimizer=OptimizerConfig(**kwargs(GammaControllerConfig,
                                                     Compressor)))
    assert str(got.value) == str(want.value)


def test_trainer_momentum_is_unchecked_like_jax():
    """JAX's trainer config checks no band for ``momentum``; neither does
    the port's (ROADMAP queue 3)."""
    for mu in (1.5, -0.5):
        JOptimizerConfig(kind="acgd", momentum=mu)
        assert OptimizerConfig(kind="acgd", momentum=mu).momentum == mu


# ---------------------------------------------------------------------------
# golden claims (tests/test_acgd.py), in the port alone
# ---------------------------------------------------------------------------

GOLD_N, GOLD_D, GOLD_STEPS, GOLD_BATCH = 512, 256, 900, 32
GOLD_GAMMA, GOLD_ETA, GOLD_MU = 0.04, 0.02, 0.5


def _golden_run(opt, steps=GOLD_STEPS, tail=400):
    """tests/test_acgd.py's _run: the interpolated quadratic from seed 0,
    minibatches of 32, the Polyak average of the last ``tail`` iterates;
    returns its full loss and the run's cumulative effective bytes."""
    A, b, _ = syn.interpolated_regression(GOLD_N, GOLD_D, feature_std=1.0,
                                          seed=0)
    w = torch.zeros(GOLD_D)
    st = opt.init(w)
    rng = np.random.default_rng(0)
    wbar = torch.zeros(GOLD_D, dtype=torch.float64)
    for t in range(steps):
        idx = torch.from_numpy(rng.integers(0, GOLD_N, GOLD_BATCH))
        Ai, bi = A[idx], b[idx]
        w, st, aux = opt.step(lambda ww: ((Ai @ ww - bi) ** 2).mean(), w, st)
        if t >= steps - tail:
            wbar += w.double()
    wbar = (wbar / tail).float()
    return float(((A @ wbar - b) ** 2).mean()), float(aux.cum_eff_bytes)


def test_golden_acgd_vs_scaled_step_csgd():
    """ACGD within 5% (+ the 5e-4 noise floor) of the Armijo-scaled
    CSGD-ASSS run at equal bytes, both at the interpolation floor."""
    comp = Compressor(gamma=GOLD_GAMMA, min_compress_size=1)
    loss_c, bytes_c = _golden_run(csgd_asss(CSGDConfig(
        armijo=ArmijoConfig(sigma=0.1, a_scale=0.3), compressor=comp)))
    loss_a, bytes_a = _golden_run(acgd(AcgdConfig(
        compressor=comp, eta=GOLD_ETA, momentum=GOLD_MU)))
    assert np.isfinite(loss_c) and loss_c < 1e-3, loss_c
    assert np.isfinite(loss_a) and loss_a < 1e-3, loss_a
    assert loss_a <= 1.05 * loss_c + 5e-4, (loss_a, loss_c)
    assert bytes_a == pytest.approx(bytes_c)


def test_golden_momentum_ablation():
    """The same eta at mu 0: the Nesterov recursion strictly improves the
    tail loss."""
    comp = Compressor(gamma=GOLD_GAMMA, min_compress_size=1)
    loss_acc, _ = _golden_run(acgd(AcgdConfig(compressor=comp, eta=GOLD_ETA,
                                              momentum=GOLD_MU)))
    loss_plain, _ = _golden_run(acgd(AcgdConfig(compressor=comp,
                                                eta=GOLD_ETA, momentum=0.0)))
    assert np.isfinite(loss_plain), loss_plain
    assert loss_acc < loss_plain, (loss_acc, loss_plain)


# ---------------------------------------------------------------------------
# the trainer's kind="acgd"
# ---------------------------------------------------------------------------

#: bucketed under the fixed schedule at gamma 0.01, and perleaf under
#: ef-coupled inside a 10% budget (the ragged kernels' path)
TRAINER = [ref.Case("acgd"),
           ref.Case("acgd", transport="perleaf", schedule="ef-coupled",
                    max_gamma=0.1, gamma=0.04)]


@pytest.mark.parametrize("case", TRAINER, ids=ref.case_id)
def test_trainer_acgd_matches_jax(case):
    _, state, log = ref.run_both(case)
    assert all(m["n_evals"] == 0 and m["alpha"] == float(f32(0.1))
               for m in log)
    assert state.alpha_prev == f32(ArmijoConfig().alpha0)
    assert all(v.dtype == torch.float32 for v in tree_leaves(state.velocity))


def test_breaker_freezes_velocity_and_server_state():
    """Non-finite rounds — parameters poisoned with a NaN, and ``eta =
    inf`` under the downlink: the port keeps the velocity, the EF memory
    and the server state it had, while the step and health counters
    advance; JAX's round of the first (the trainer case above, compiled
    once) freezes its velocity and EF memory the same way."""
    _, jparams = ref.jax_model()
    flat, treedef = jax.tree.flatten(jax.tree.map(np.array, jparams))
    flat[0][0] = np.nan
    # fresh arrays, as the reference round was compiled for
    poisoned = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in flat])
    vel = jax.tree.map(lambda p: jnp.asarray(np.full(p.shape, 0.25,
                                                     np.float32)), jparams)
    batch = syn.TokenPipeline(vocab_size=get_smoke_config(
        ref.ARCH).vocab_size, seq_len=ref.SEQ,
        global_batch=ref.BATCH).batch(0)
    for case, start in ((ref.Case("acgd"), poisoned), (ref.Case(
            "acgd", eta=float("inf"), downlink="compressed"), jparams)):
        run = case.run()
        params = to_torch(jax.tree.map(np.asarray, start))
        state = dataclasses.replace(init_train_state(params, run),
                                    velocity=to_torch(jax.tree.map(
                                        np.asarray, vel)))
        new_params, new_state, m = train_step(params, state, batch, run)
        assert (m["steps_skipped"], m["consecutive_skips"]) == (1.0, 1.0)
        assert new_state.velocity is state.velocity
        assert new_state.memory is state.memory
        assert new_state.downlink is state.downlink
        assert new_state.step == 1 and new_params is params
    assert new_state.downlink is not None
    assert new_state.cum_eff_bytes == f32(
        m["effective_wire_bytes"]) + f32(m["downlink_effective_wire_bytes"])
    ctx = (jnp.float32(ArmijoConfig().alpha0), jnp.float32(0.0),
           jnp.float32(0.01), jnp.int32(0), ref.JTel.init(),
           ref.JHealth.init(), jnp.float32(0.0), jnp.float32(0.0))
    mem = jax.tree.map(jnp.zeros_like, jparams)
    out = ref.jax_step(ref.Case("acgd"))(
        poisoned, mem, vel, jnp.zeros((0,), jnp.float32), ctx,
        {"tokens": jnp.asarray(batch["tokens"])})
    assert not bool(out[6])
    for a, b in zip(jax.tree.leaves(out[1:3]), jax.tree.leaves((mem, vel))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_opt_acgd_and_momentum():
    """``--opt acgd --momentum``: no search, alpha = eta, compressed
    bytes; the first step from zero velocity keeps v' = g whatever mu, and
    sends mu*g + g, so mu changes the parameters but not the velocity."""
    base = ["--device", "cpu", "--smoke", "--seq-len", "33",
            "--global-batch", "4", "--compress-method", "block_topk",
            "--log-every", "1", "--steps", "1", "--opt", "acgd",
            "--eta", "0.05"]
    assert train_cli.parse_args(base).momentum == 0.9
    runs = {mu: train_cli.run(base + ["--momentum", str(mu)])
            for mu in (0.9, 0.0)}
    for log, _, state in runs.values():
        assert log[0]["n_evals"] == 0.0
        assert log[0]["alpha"] == float(f32(0.05))
        assert log[0]["wire_bytes"] < 4 * sum(
            p.numel() for p in tree_leaves(state.velocity))
    (_, p9, s9), (_, p0, s0) = runs[0.9], runs[0.0]
    for a, b in zip(tree_leaves(s9.velocity), tree_leaves(s0.velocity)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(p9), tree_leaves(p0)))
