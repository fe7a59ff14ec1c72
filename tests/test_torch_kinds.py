"""The trainer's optimizer kinds, microbatches and step-health breaker
against the JAX package: ``nonadaptive``, ``sls``, ``sgd`` / ``dense`` and
``csgd_asss``, gradient accumulation over microbatches, the skip gate
with ``max_consecutive_skips`` on and off, ``DivergenceError``, the
configuration's validation errors and the CLI flags.

The JAX reference composes the plain body of ``worker_fn``
(src/repro/launch/train_step.py) from the JAX package's own functions —
``armijo_search``, ``gamma_update``, ``worker_compress_aggregate``,
``dense_aggregate``, ``all_finite``, ``advance_health`` and its
``lax.scan`` microbatch loop — jitted, with the model OUTSIDE any mesh
(the LM step under a mesh fails on this tree, ROADMAP queue 3); only the
exchange runs in a 1-device ``shard_map``, for its collectives.

Tolerances as in tests/test_torch_train.py: loss and alpha within rel
1e-5, parameters and EF memory within 1e-5 of the parameter leaf's max
|p|.  gamma_t bit for bit; byte counts, ``n_evals``, ``alpha == eta``
and the health counters exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import ArmijoConfig as JArmijo
from repro.core import Compressor as JCompressor
from repro.core.armijo import armijo_search as jarmijo
from repro.core.armijo import next_alpha_max as jnext_alpha_max
from repro.core.armijo import tree_sqnorm as jsqnorm
from repro.core.dcsgd import dense_aggregate as jdense
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.core.gamma import gamma_init as jgamma_init
from repro.core.gamma import gamma_update as jgamma_update
from repro.core.health import DivergenceError as JDivergenceError
from repro.core.health import HealthState as JHealth
from repro.core.health import advance_health as jadvance_health
from repro.core.health import all_finite as jall_finite
from repro.core.health import check_divergence as jcheck_divergence
from repro.core.telemetry import CompressionTelemetry as JTel
from repro.core.telemetry import SearchTelemetry as JSearch
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro.models import build_model
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.core.health import DivergenceError, check_divergence
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_step import init_train_state, \
    microbatch_mean, train_step

torch.set_num_threads(2)

ARCH = "paper-lm-100m"
SEQ, BATCH, GAMMA, STEPS = 33, 6, 0.01, 3
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Case:
    """One trainer configuration, in the terms both packages share."""

    kind: str
    value_bits: int = 32
    transport: str = "bucketed"
    schedule: str = "fixed"
    max_gamma: float = 0.0
    micro: int = 1
    eta: float = 0.1
    max_skips: int = 25

    def comp_kw(self):
        return dict(gamma=GAMMA, method="block_topk",
                    value_bits=self.value_bits, max_gamma=self.max_gamma)

    def ctrl_kw(self):
        return dict(schedule=self.schedule, ramp_steps=2)

    def run(self) -> RunConfig:
        return RunConfig(
            model=get_smoke_config(ARCH), shape=ShapeConfig(SEQ, BATCH),
            microbatches=self.micro,
            optimizer=OptimizerConfig(
                kind=self.kind, eta=self.eta,
                max_consecutive_skips=self.max_skips,
                compressor=Compressor(**self.comp_kw()),
                gamma_controller=GammaControllerConfig(**self.ctrl_kw()),
                transport=self.transport))


@functools.lru_cache(maxsize=None)
def _jax_model():
    model = build_model(jax_smoke_config(ARCH))
    return model, model.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_step(case: Case):
    """One worker's round of ``worker_fn``'s plain body for ``case``,
    jitted.  ``ctx``: (alpha_prev, n_evals_ema, gamma_prev, step, last
    round's telemetry, health); returns the new one with the round's
    loss, alpha and n_evals metrics, bytes and gate verdict."""
    model, _ = _jax_model()
    comp = JCompressor(**case.comp_kw())
    arm = JArmijo()
    ctrl = JGammaCfg(**case.ctrl_kw())
    mesh = jax.make_mesh((1,), ("data",))
    micro = case.micro
    compressing = case.kind in ("csgd_asss", "nonadaptive")
    breaker_on = case.max_skips > 0

    def local_loss(params, batch):
        return model.loss(params, batch)[0]

    @jax.jit
    def step(params, mem, ctx, batch):
        alpha_prev, ema, gamma_prev, t, tel_prev, health = ctx
        # worker_fn:664-682
        if micro > 1:
            mbs = jax.tree.map(
                lambda x: x.reshape(micro, x.shape[0] // micro,
                                    *x.shape[1:]), batch)
            probe = jax.tree.map(lambda x: x[0], mbs)

            def acc(carry, mb):
                lo, g = jax.value_and_grad(local_loss)(params, mb)
                cl, cg = carry
                return (cl + lo, jax.tree.map(jnp.add, cg, g)), None

            zero_g = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (loss_sum, grads), _ = jax.lax.scan(
                acc, (jnp.float32(0.0), zero_g), mbs)
            loss = loss_sum / micro
            grads = jax.tree.map(lambda g: g / micro, grads)
        else:
            probe = batch
            loss, grads = jax.value_and_grad(local_loss)(params, batch)
        gsq = jsqnorm(grads)
        # worker_fn:685-719
        if case.kind in ("csgd_asss", "sls"):
            res = jarmijo(lambda p: local_loss(p, probe), params, grads,
                          jnext_alpha_max(alpha_prev, arm), arm,
                          grad_sqnorm=gsq)
            new_alpha = res.alpha
            new_ema = 0.9 * ema + 0.1 * res.n_evals.astype(jnp.float32)
            alpha_m, evals_m = res.alpha, res.n_evals.astype(jnp.float32)
            search = JSearch(alpha=res.alpha, alpha_prev=alpha_prev,
                             n_evals=res.n_evals, n_evals_ema=ema)
        else:
            res, search = None, None
            new_alpha, new_ema = alpha_prev, ema
            alpha_m, evals_m = jnp.float32(case.eta), jnp.float32(0.0)
        gamma_t = jgamma_update(ctrl, comp, gamma_prev, t, search=search,
                                compression=tel_prev)
        eta = arm.scale_for(gamma_t) * res.alpha if res is not None \
            else jnp.float32(case.eta)
        # worker_fn:722-832
        spec = jax.tree.map(lambda _: P(), params)
        if compressing:
            upd, new_mem, wire, eff, tel = shard_map(
                lambda g, m, e, gt: jwca(
                    g, m, e, comp, ("data",),
                    stacked_mask=model.stacked_mask(params), gamma_t=gt,
                    transport=case.transport),
                mesh=mesh, in_specs=(spec, spec, P(), P()),
                out_specs=(spec, spec, P(), P(), P()),
                axis_names={"data"})(grads, mem, eta, gamma_t)
        else:
            upd, wire = shard_map(
                lambda g, e: jdense(g, e, ("data",)), mesh=mesh,
                in_specs=(spec, P()), out_specs=(spec, P()),
                axis_names={"data"})(grads, eta)
            eff, new_mem, tel = wire, mem, tel_prev
        new_params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) - u).astype(p.dtype),
            params, upd)
        # worker_fn:856-941
        step_ok = jnp.isfinite(loss) & jall_finite(upd)
        if breaker_on:
            new_params = jax.tree.map(
                lambda a, b: jnp.where(step_ok, a, b), new_params, params)
        new_health = jadvance_health(health, step_ok, t, jnp.float32(0.0))
        new_ctx = (new_alpha, new_ema, gamma_t, t + 1, tel, new_health)
        if breaker_on:
            frozen = (alpha_prev, ema, gamma_prev, t + 1, tel_prev,
                      new_health)
            new_ctx, new_mem = jax.tree.map(
                lambda a, b: jnp.where(step_ok, a, b),
                (new_ctx, new_mem), (frozen, mem))
        return (new_params, new_mem, new_ctx, loss, alpha_m, evals_m,
                wire, eff, step_ok)

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


def _health(state) -> tuple:
    h = state.health
    return (h.steps_skipped, h.consecutive_skips, h.last_good_step,
            float(h.rows_quarantined))


def _jhealth(h) -> tuple:
    return (int(h.steps_skipped), int(h.consecutive_skips),
            int(h.last_good_step), float(h.rows_quarantined))


def _run_both(case: Case, steps: int = STEPS):
    """``steps`` rounds of ``case`` through both packages from JAX's
    initial weights, checked round by round.  Each round starts the port
    from the reference's parameters and EF memory (its carried host
    scalars — alpha, the evals mean, gamma_t, telemetry, health — stay
    its own): free running, an ulp of one round can split a near-tie at
    a block's threshold in the next and move a whole entry (at 8 bits,
    mlp/wg split |acc| 0.0012482208 / 0.0012482204 at step 1 and the
    embedding's memory followed at step 2).  Returns the port's last
    parameters, its state and its metrics."""
    _, params = _jax_model()
    comp = JCompressor(**case.comp_kw())
    ctrl = JGammaCfg(**case.ctrl_kw())
    # JAX's worker_fn runs sgd and dense through one branch
    jstep = _jax_step(dataclasses.replace(case, kind="sgd")
                      if case.kind == "dense" else case)
    mem = jax.tree.map(jnp.zeros_like, params)
    ctx = (jnp.float32(JArmijo().alpha0), jnp.float32(0.0),
           jgamma_init(ctrl, comp), jnp.int32(0), JTel.init(),
           JHealth.init())
    run = case.run()
    state = init_train_state(to_torch(jax.tree.map(np.asarray, params)),
                             run)
    assert (state.memory is None) == (case.kind in ("sls", "sgd", "dense"))
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                         global_batch=BATCH)
    log = []
    for t in range(steps):
        batch = pipe.batch(t)
        tparams = to_torch(jax.tree.map(np.asarray, params))
        if state.memory is not None:
            state = dataclasses.replace(
                state, memory=to_torch(jax.tree.map(np.asarray, mem)))
        (params, mem, ctx, loss, alpha_m, evals_m, wire, eff,
         _) = jstep(params, mem, ctx, {"tokens": jnp.asarray(
             batch["tokens"])})
        tparams, state, m = train_step(tparams, state, batch, run)
        log.append(m)
        np.testing.assert_allclose(m["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(state.alpha_prev), float(ctx[0]),
                                   rtol=1e-5)
        assert m["n_evals"] == float(evals_m), t
        if case.kind in ("nonadaptive", "sgd", "dense"):
            assert m["alpha"] == float(f32(case.eta)) == float(alpha_m)
            assert state.alpha_prev == f32(JArmijo().alpha0)
            assert state.n_evals_ema == 0.0
        else:
            np.testing.assert_allclose(m["alpha"], float(alpha_m),
                                       rtol=1e-5)
        assert f32(state.gamma).view(np.int32) == \
            np.asarray(ctx[2], np.float32).view(np.int32), t
        assert (m["wire_bytes"], m["effective_wire_bytes"]) == \
            (float(wire), float(eff))
        assert _health(state) == _jhealth(ctx[5]), t
        assert (m["steps_skipped"], m["consecutive_skips"],
                m["last_good_step"], m["rows_quarantined"]) == \
            tuple(map(float, _jhealth(ctx[5])))
        _assert_tree_close(params, tparams, params, f"step {t} params")
        if state.memory is not None:
            _assert_tree_close(mem, state.memory, params,
                               f"step {t} memory")
    return tparams, state, log


#: nonadaptive on bucketed at 32 and 8 bits and on perleaf inside a 10%
#: budget under the linear ramp; sls; csgd_asss and nonadaptive over
#: 2 and 3 microbatches
CASES = [Case("nonadaptive"), Case("nonadaptive", value_bits=8),
         Case("nonadaptive", value_bits=8, transport="perleaf",
              schedule="linear", max_gamma=0.1),
         Case("sls"),
         Case("csgd_asss", micro=2), Case("csgd_asss", micro=3),
         Case("nonadaptive", micro=2), Case("nonadaptive", micro=3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{v}" for k, v in dataclasses.asdict(c).items()
    if v != getattr(Case, k, None) or k == "kind"))
def test_kind_steps_match_jax(case):
    _run_both(case)


def test_sgd_and_dense_are_one_path():
    """``sgd`` and ``dense`` against JAX, and bit for bit the same as
    each other (one path in JAX's ``worker_fn``): parameters, state,
    metrics and the dense bytes, 4 bytes a parameter."""
    sgd_params, sgd_state, sgd_log = _run_both(Case("sgd"))
    params, state, log = _run_both(Case("dense"))
    assert log == sgd_log
    n_params = sum(p.numel() for p in jax.tree.leaves(params))
    assert all(m["wire_bytes"] == m["effective_wire_bytes"] == 4 * n_params
               for m in log)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(sgd_params)):
        assert torch.equal(a, b)
    assert state == sgd_state


@pytest.mark.parametrize("max_skips", [25, 0])
def test_non_finite_round_gated_or_written_through(max_skips):
    """A round made non-finite (``eta = inf``): with the breaker on the
    parameters and the carried state stay as they were while the step
    and health counters advance; with ``max_consecutive_skips`` 0 the
    round writes through, as JAX's does.  Both against JAX."""
    case = Case("sgd", eta=float("inf"), max_skips=max_skips)
    _, jparams = _jax_model()
    ctrl, comp = JGammaCfg(**case.ctrl_kw()), JCompressor(**case.comp_kw())
    ctx = (jnp.float32(0.1), jnp.float32(0.0), jgamma_init(ctrl, comp),
           jnp.int32(0), JTel.init(), JHealth.init())
    run = case.run()
    params0 = to_torch(jax.tree.map(np.asarray, jparams))
    state = init_train_state(params0, run)
    batch = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                          global_batch=BATCH).batch(0)
    jout = _jax_step(case)(jparams, jparams, ctx,
                           {"tokens": jnp.asarray(batch["tokens"])})
    params, new_state, m = train_step(params0, state, batch, run)
    assert not bool(jout[8])
    assert _health(new_state) == _jhealth(jout[2][5]) == (1, 1, -1, 0.0)
    assert (m["steps_skipped"], m["consecutive_skips"],
            m["last_good_step"]) == (1.0, 1.0, -1.0)
    assert new_state.step == 1
    leaves = jax.tree.leaves(params)
    jleaves = jax.tree.leaves(jout[0])
    if max_skips:
        assert all(a is b for a, b in zip(leaves, jax.tree.leaves(params0)))
        assert dataclasses.replace(new_state, step=0, health=state.health,
                                   cum_wire_bytes=f32(0.0),
                                   cum_eff_bytes=f32(0.0)) == state
        for a, b in zip(jleaves, jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    # written through: the same non-finite entries (±inf where the grad is
    # non-zero, NaN where it is 0) in both packages
    assert not all(bool(torch.isfinite(a).all()) for a in leaves)
    for a, b in zip(leaves, jleaves):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    assert new_state.alpha_prev == state.alpha_prev
    assert m["alpha"] == float("inf")


@pytest.mark.parametrize("metrics,threshold", [
    ({"step": 7, "consecutive_skips": 3.0, "last_good_step": 4.0}, 3),
    ({"step": 1, "consecutive_skips": 2.0, "last_good_step": -1.0}, 2),
    ({"step": 9, "consecutive_skips": 2.0, "last_good_step": 6.0}, 3),
    ({"step": 9, "consecutive_skips": 30.0, "last_good_step": 6.0}, 0),
    ({"step": 9}, 3)])
def test_check_divergence_matches_jax(metrics, threshold):
    """The host-side breaker raises where JAX's does, with its fields and
    its message, and is a no-op where JAX's is."""
    def outcome(fn, err):
        try:
            fn(metrics, threshold)
        except err as e:
            return (e.step, e.last_good_step, e.consecutive, e.threshold,
                    str(e))
        return None
    want = outcome(jcheck_divergence, JDivergenceError)
    assert outcome(check_divergence, DivergenceError) == want
    assert (want is not None) == (threshold > 0 and metrics.get(
        "consecutive_skips", 0) >= threshold)


def _jax_build_error(kind, schedule):
    jrun = JRunConfig(model=jax_smoke_config(ARCH),
                      shape=JShapeConfig("cli", SEQ, BATCH, "train"),
                      optimizer=JOptimizerConfig(
                          kind=kind, compressor=JCompressor(max_gamma=0.1),
                          gamma_controller=JGammaCfg(schedule=schedule)))
    with pytest.raises(ValueError) as e:
        jbuild_train_step(None, jrun, None)
    return str(e.value)


@pytest.mark.parametrize("kind,schedule", [
    ("nonadaptive", "armijo-coupled"), ("sgd", "armijo-coupled"),
    ("dense", "armijo-coupled"), ("sls", "ef-coupled"),
    ("sgd", "ef-coupled")])
def test_schedule_kind_errors_match_jax(kind, schedule):
    with pytest.raises(ValueError) as e:
        OptimizerConfig(kind=kind, compressor=Compressor(max_gamma=0.1),
                        gamma_controller=GammaControllerConfig(
                            schedule=schedule))
    assert str(e.value) == _jax_build_error(kind, schedule)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="acgd", local_steps=2, microbatches=2), "acgd"),
    (dict(kind="adam"), "unknown optimizer"),
    (dict(ef_dtype="int8"), "int8"),
    (dict(shard_local_topk=True), "shard-local top-k"),
    (dict(downlink="compressed", kind="sls"), "downlink"),
    (dict(max_consecutive_skips=-1), "max_consecutive_skips must be >= 0")])
def test_config_refuses_what_is_not_ported(kw, match):
    """The fields of the JAX paths not ported and the combinations JAX's
    trainer refuses (acgd with local steps, the compressed downlink of a
    kind that does not compress) raise, never run silently as something
    else."""
    kw = dict(kw)
    micro = kw.pop("microbatches", 1)
    with pytest.raises(ValueError, match=match):
        RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig(SEQ, BATCH),
                  microbatches=micro, optimizer=OptimizerConfig(**kw))


@pytest.mark.parametrize("micro", [2, 3, 7])
def test_microbatch_mean_follows_jitted_jax(micro):
    """``loss_sum / micro`` and ``g / micro`` of ``worker_fn`` bit for bit
    as jitted XLA computes them (a product with f32(1/micro)); at micro
    3 and 7 a plain division differs in a third or more of the values."""
    x = np.random.default_rng(micro).standard_normal(20_000).astype(f32)
    want = np.asarray(jax.jit(lambda g: g / micro)(x))
    got = microbatch_mean(torch.from_numpy(x.copy()), micro).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert float(microbatch_mean(torch.tensor(x[0]), micro)) == \
        float(jax.jit(lambda s: s / micro)(jnp.float32(x[0])))
    if micro != 2:
        assert (x / f32(micro) != want).mean() > 0.3


def test_microbatches_must_split_the_local_batch():
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        Case("csgd_asss", micro=0).run()
    run = Case("csgd_asss", micro=4).run()
    params = to_torch(jax.tree.map(np.asarray, _jax_model()[1]))
    batch = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                          global_batch=BATCH).batch(0)
    with pytest.raises(ValueError, match="does not split into 4"):
        train_step(params, init_train_state(params, run), batch, run)


def test_cli_kinds_and_breaker(capsys):
    """The CLI on the CPU with ``--opt``, ``--eta``, ``--microbatches``
    and ``--max-consecutive-skips``; ``--eta inf`` trips the breaker."""
    base = ["--device", "cpu", "--smoke", "--seq-len", str(SEQ),
            "--global-batch", str(BATCH), "--compress-method",
            "block_topk", "--log-every", "1"]
    log = train_cli.main(base + ["--steps", "2", "--opt", "nonadaptive",
                                 "--eta", "0.05", "--microbatches", "3",
                                 "--max-consecutive-skips", "3"])
    assert [m["step"] for m in log] == [0, 1]
    assert all(m["alpha"] == float(f32(0.05)) and m["n_evals"] == 0
               and np.isfinite(m["loss"]) for m in log)
    with pytest.raises(DivergenceError) as e:
        train_cli.main(base + ["--steps", "5", "--opt", "sgd", "--eta",
                               "inf", "--max-consecutive-skips", "2"])
    assert (e.value.step, e.value.last_good_step, e.value.consecutive,
            e.value.threshold) == (1, -1, 2, 2)
    assert "skips=1 quar=0" in capsys.readouterr().out
    log = train_cli.main(base + ["--steps", "3", "--opt", "sgd", "--eta",
                                 "inf", "--max-consecutive-skips", "0"])
    assert [m["steps_skipped"] for m in log] == [1.0, 2.0, 3.0]
    assert [m["last_good_step"] for m in log] == [-1.0] * 3
