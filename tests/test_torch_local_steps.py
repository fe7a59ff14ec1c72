"""The trainer's local-steps round and its bf16 EF memory against the JAX
package: ``_local_steps_worker`` (H local Armijo-SGD steps on the
worker's H microbatches, then one EF-compressed exchange of the model
delta at eta 1), on both transports, for ``csgd_asss`` and
``nonadaptive``, adaptive and with bf16 EF memory; the kinds that ignore
``local_steps``; the build-time error; the int8 EF memory JAX's trainer
truncates; the CLI flags.

The JAX reference composes ``_local_steps_worker``
(src/repro/launch/train_step.py:381-509) from the JAX package's own
functions — ``armijo_search``, ``next_alpha_max``, ``gamma_update``,
``worker_compress_aggregate``, ``all_finite``, ``advance_health`` and a
``lax.scan`` over the H microbatches written as the worker writes it —
jitted, with the model OUTSIDE any mesh (the LM step under a mesh fails
on this tree, ROADMAP queue 3); only the exchange runs in a 1-device
``shard_map``, for its collectives.

Tolerances as in tests/test_torch_kinds.py: loss and alpha within rel
1e-5, parameters and EF memory within 1e-5 of the parameter leaf's max
|p| (bf16 memory: plus the cast's one bf16 ulp, in at most one entry in
1,000).  gamma_t, ``alpha_prev``, ``n_evals_ema``, ``n_evals``, the byte
counts and the health counters bit for bit.  Each round starts the port
from the reference's parameters and EF memory (the near-tie rule of
ROADMAP queue 3).
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
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.core.gamma import gamma_init as jgamma_init
from repro.core.gamma import gamma_update as jgamma_update
from repro.core.health import HealthState as JHealth
from repro.core.health import advance_health as jadvance_health
from repro.core.health import all_finite as jall_finite
from repro.core.telemetry import CompressionTelemetry as JTel
from repro.core.telemetry import SearchTelemetry as JSearch
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro.models import build_model
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.armijo import local_evals_ema, reciprocal_product
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.utils import tree_leaves

torch.set_num_threads(2)

ARCH = "paper-lm-100m"
SEQ, BATCH, GAMMA, ROUNDS = 33, 6, 0.01, 3
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Case:
    """One local-steps configuration, in the terms both packages share."""

    kind: str = "csgd_asss"
    H: int = 2
    transport: str = "bucketed"
    schedule: str = "fixed"
    max_gamma: float = 0.0
    ef_dtype: str = "float32"

    def comp_kw(self):
        return dict(gamma=GAMMA, method="block_topk",
                    max_gamma=self.max_gamma)

    def ctrl_kw(self):
        return dict(schedule=self.schedule, ramp_steps=2)

    def run(self, **opt_kw) -> RunConfig:
        kw = dict(kind=self.kind, local_steps=self.H,
                  ef_dtype=self.ef_dtype,
                  compressor=Compressor(**self.comp_kw()),
                  gamma_controller=GammaControllerConfig(**self.ctrl_kw()),
                  transport=self.transport)
        kw.update(opt_kw)
        return RunConfig(model=get_smoke_config(ARCH),
                         shape=ShapeConfig(SEQ, BATCH),
                         microbatches=self.H,
                         optimizer=OptimizerConfig(**kw))


@functools.lru_cache(maxsize=None)
def _jax_model():
    model = build_model(jax_smoke_config(ARCH))
    return model, model.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_round(case: Case):
    """One worker's ``_local_steps_worker`` round for ``case``, jitted.
    ``ctx``: (alpha_prev, n_evals_ema, gamma_prev, step, last round's
    telemetry, health); returns the new one with the round's loss, alpha
    and n_evals metrics, bytes and gate verdict."""
    model, _ = _jax_model()
    comp = JCompressor(**case.comp_kw())
    arm = JArmijo()
    ctrl = JGammaCfg(**case.ctrl_kw())
    mesh = jax.make_mesh((1,), ("data",))
    H = case.H

    def local_loss(params, batch):
        return model.loss(params, batch)[0]

    @jax.jit
    def step(params, mem, ctx, batch):
        alpha_prev, ema, gamma_prev, t, tel_prev, health = ctx
        # _local_steps_worker:386-404
        mbs = jax.tree.map(
            lambda x: x.reshape(H, x.shape[0] // H, *x.shape[1:]), batch)

        def one(carry, mb):
            p_loc, amax, ev = carry
            loss, g = jax.value_and_grad(local_loss)(p_loc, mb)
            gsq = jsqnorm(g)
            res = jarmijo(lambda p: local_loss(p, mb), p_loc, g, amax, arm,
                          f0=loss, grad_sqnorm=gsq)
            eta = arm.a_scale * res.alpha
            p_loc = jax.tree.map(
                lambda p, gg: (p.astype(jnp.float32)
                               - eta * gg.astype(jnp.float32)).astype(p.dtype),
                p_loc, g)
            return (p_loc, jnext_alpha_max(res.alpha, arm),
                    ev + res.n_evals.astype(jnp.float32)), (loss, res.alpha)

        amax0 = jnext_alpha_max(alpha_prev, arm)
        (p_end, amax_f, evals), (losses, alphas) = jax.lax.scan(
            one, (params, amax0, jnp.float32(0.0)), mbs)
        # :408-416
        gamma_t = jgamma_update(
            ctrl, comp, gamma_prev, t,
            search=JSearch(alpha=alphas[-1], alpha_prev=alpha_prev,
                           n_evals=evals / H, n_evals_ema=ema),
            compression=tel_prev)
        # :418-449
        delta = jax.tree.map(
            lambda a, b: a.astype(jnp.float32) - b.astype(jnp.float32),
            params, p_end)
        spec = jax.tree.map(lambda _: P(), params)
        upd, new_mem, wire, eff, tel = shard_map(
            lambda d, m, gt: jwca(
                d, m, jnp.float32(1.0), comp, ("data",),
                stacked_mask=model.stacked_mask(params), gamma_t=gt,
                transport=case.transport),
            mesh=mesh, in_specs=(spec, spec, P()),
            out_specs=(spec, spec, P(), P(), P()),
            axis_names={"data"})(delta, mem, gamma_t)
        new_params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) - u).astype(p.dtype),
            params, upd)
        loss = jnp.mean(losses)
        # :472-508
        step_ok = jnp.isfinite(loss) & jall_finite(upd)
        new_params = jax.tree.map(
            lambda a, b: jnp.where(step_ok, a, b), new_params, params)
        new_health = jadvance_health(health, step_ok, t, jnp.float32(0.0))
        new_ctx = (amax_f / arm.omega, 0.9 * ema + 0.1 * evals / H,
                   gamma_t, t + 1, tel, new_health)
        frozen = (alpha_prev, ema, gamma_prev, t + 1, tel_prev, new_health)
        new_ctx, new_mem = jax.tree.map(
            lambda a, b: jnp.where(step_ok, a, b),
            (new_ctx, new_mem), (frozen, mem))
        return (new_params, new_mem, new_ctx, loss, alphas[-1], evals / H,
                wire, eff, step_ok)

    return step


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


def _assert_tree_close(jtree, ttree, ptree, what):
    """|jax - torch| <= 1e-5 * max|p| per leaf, p the parameter leaf.  A
    bf16 EF memory leaf is the bf16 rounding of an f32 residual held to
    that bound, so an entry may also differ by the one bf16 ulp the cast
    adds where the two residuals straddle a rounding midpoint — in at
    most one entry in 1,000 (an f32 difference of n ulps crosses a
    bf16 rounding midpoint with probability about n * 2**-16)."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            _assert_tree_close(v, ttree[k], ptree[k], f"{what}/{k}")
            continue
        a = np.asarray(v, np.float32)
        b = ttree[k].detach().float().numpy()
        tol = 1e-5 * float(np.abs(np.asarray(ptree[k])).max())
        err = np.abs(a - b)
        if ttree[k].dtype == torch.bfloat16:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a),
                                                      1e-30))) - 7)
            assert (err <= tol + ulp).all(), \
                f"{what}/{k}: {(err - ulp).max()} past one bf16 ulp"
            assert (err > tol).mean() <= 1e-3, \
                f"{what}/{k}: {(err > tol).sum()} of {err.size} entries " \
                "a bf16 ulp apart"
            continue
        assert err.max() <= tol, f"{what}/{k}: {err.max()} vs {tol}"


def _jhealth(h) -> tuple:
    return (int(h.steps_skipped), int(h.consecutive_skips),
            int(h.last_good_step), float(h.rows_quarantined))


def _jax_memory(params, ef_dtype):
    return jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.dtype(ef_dtype)),
                        params)


def _run_both(case: Case, rounds: int = ROUNDS):
    """``rounds`` local-steps rounds of ``case`` through both packages
    from JAX's initial weights, checked round by round; each round
    starts the port from the reference's parameters and EF memory (its
    carried host scalars stay its own).  Returns the port's metrics."""
    _, params = _jax_model()
    comp = JCompressor(**case.comp_kw())
    ctrl = JGammaCfg(**case.ctrl_kw())
    jstep = _jax_round(case)
    mem = _jax_memory(params, case.ef_dtype)
    # strongly typed leaves, as the jitted round returns them
    ctx = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.asarray(x).dtype),
        (jnp.float32(JArmijo().alpha0), jnp.float32(0.0),
         jgamma_init(ctrl, comp), jnp.int32(0), JTel.init(),
         JHealth.init()))
    run = case.run()
    state = init_train_state(to_torch(jax.tree.map(np.asarray, params)),
                             run)
    want_dtype = getattr(torch, case.ef_dtype)
    assert all(m.dtype == want_dtype for m in tree_leaves(state.memory))
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                         global_batch=BATCH)
    log = []
    for t in range(rounds):
        batch = pipe.batch(t)
        tparams = to_torch(jax.tree.map(np.asarray, params))
        state = dataclasses.replace(
            state, memory=to_torch(jax.tree.map(np.asarray, mem)))
        (params, mem, ctx, loss, alpha_m, evals_m, wire, eff,
         ok) = jstep(params, mem, ctx, {"tokens": jnp.asarray(
             batch["tokens"])})
        # uncommitted again, as the first round's inputs: one compile
        params, mem, ctx = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                                        (params, mem, ctx))
        tparams, state, m = train_step(tparams, state, batch, run)
        log.append(m)
        assert bool(ok) and not m["steps_skipped"], t
        np.testing.assert_allclose(m["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(m["alpha"], float(alpha_m), rtol=1e-5)
        assert m["grad_sqnorm"] == 0.0
        # the carried scalars and the round's evals mean, bit for bit
        assert _bits(state.alpha_prev) == _bits(ctx[0]), t
        assert _bits(state.n_evals_ema) == _bits(ctx[1]), t
        assert _bits(m["n_evals"]) == _bits(evals_m), t
        assert _bits(state.gamma) == _bits(ctx[2]), t
        assert m["n_evals"] >= 1.0
        assert (m["wire_bytes"], m["effective_wire_bytes"]) == \
            (float(wire), float(eff))
        h = state.health
        assert (h.steps_skipped, h.consecutive_skips, h.last_good_step,
                float(h.rows_quarantined)) == _jhealth(ctx[5]), t
        assert (m["steps_skipped"], m["consecutive_skips"],
                m["last_good_step"], m["rows_quarantined"]) == \
            tuple(map(float, _jhealth(ctx[5])))
        assert state.step == int(ctx[3]) == t + 1
        _assert_tree_close(params, tparams, params, f"round {t} params")
        assert all(x.dtype == want_dtype for x in tree_leaves(state.memory))
        _assert_tree_close(mem, state.memory, params, f"round {t} memory")
    return log


#: H 2 and 3 on both transports for both compressing kinds; a 10% budget
#: under the linear ramp; armijo-coupled at H 3, where the controller
#: reads evals / H; bf16 EF memory on both transports
CASES = [Case(H=2), Case(H=3, transport="perleaf"),
         Case("nonadaptive", H=2, transport="perleaf"),
         Case("nonadaptive", H=3),
         Case(H=2, transport="perleaf", schedule="linear", max_gamma=0.1),
         Case(H=3, schedule="armijo-coupled", max_gamma=0.1),
         Case(H=2, ef_dtype="bfloat16"),
         Case("nonadaptive", H=3, transport="perleaf",
              ef_dtype="bfloat16")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{v}" for k, v in dataclasses.asdict(c).items()
    if v != getattr(Case, k, None) or k in ("kind", "H")))
def test_local_steps_rounds_match_jax(case):
    log = _run_both(case)
    if case.max_gamma:
        # the controller moved gamma_t off its initial level
        assert {m["gamma"] for m in log} != {float(f32(GAMMA))}


def test_nonadaptive_searches_under_local_steps():
    """``_local_steps_worker`` has no branch on the kind: ``nonadaptive``
    runs the Armijo search on every local step (ROADMAP queue 3), while
    its plain round steps at ``eta`` without one."""
    case = Case("nonadaptive", H=2)
    log = _run_both(case, rounds=1)
    assert log[0]["n_evals"] >= 1 and log[0]["alpha"] != float(f32(0.1))
    params = to_torch(jax.tree.map(np.asarray, _jax_model()[1]))
    plain = dataclasses.replace(case.run(), microbatches=1,
                                optimizer=dataclasses.replace(
                                    case.run().optimizer, local_steps=1))
    batch = TokenPipeline(vocab_size=plain.model.vocab_size, seq_len=SEQ,
                          global_batch=BATCH).batch(0)
    _, _, m = train_step(params, init_train_state(params, plain), batch,
                         plain)
    assert (m["n_evals"], m["alpha"]) == (0.0, float(f32(0.1)))


@pytest.mark.parametrize("kind", ["sls", "sgd", "dense"])
def test_other_kinds_ignore_local_steps(kind):
    """JAX's ``worker_fn`` takes the local-steps round only for the
    compressing kinds; ``sls``, ``sgd`` and ``dense`` with
    ``local_steps=2`` run the plain path, bit for bit the same as with
    1 (and no microbatches == local_steps requirement)."""
    params = to_torch(jax.tree.map(np.asarray, _jax_model()[1]))
    runs = [RunConfig(model=get_smoke_config(ARCH),
                      shape=ShapeConfig(SEQ, BATCH),
                      optimizer=OptimizerConfig(kind=kind, local_steps=h))
            for h in (1, 2)]
    batch = TokenPipeline(vocab_size=runs[0].model.vocab_size, seq_len=SEQ,
                          global_batch=BATCH).batch(0)
    out = [train_step(params, init_train_state(params, r), batch, r)
           for r in runs]
    assert out[0][2] == out[1][2]
    assert out[0][1] == out[1][1]
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,micro", [("csgd_asss", 1), ("csgd_asss", 3),
                                        ("nonadaptive", 4)])
def test_microbatches_must_equal_local_steps_as_in_jax(kind, micro):
    """The build-time contract of ``build_train_step``, word for word."""
    jrun = JRunConfig(model=jax_smoke_config(ARCH),
                      shape=JShapeConfig("cli", SEQ, BATCH, "train"),
                      optimizer=JOptimizerConfig(kind=kind, local_steps=2),
                      microbatches=micro)
    with pytest.raises(ValueError) as want:
        jbuild_train_step(None, jrun, jax.make_mesh((1,), ("data",)))
    with pytest.raises(ValueError) as got:
        RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig(SEQ, BATCH),
                  microbatches=micro,
                  optimizer=OptimizerConfig(kind=kind, local_steps=2))
    assert str(got.value) == str(want.value)


def test_local_steps_must_split_the_local_batch():
    run = Case(H=4).run()
    params = to_torch(jax.tree.map(np.asarray, _jax_model()[1]))
    batch = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                          global_batch=BATCH).batch(0)
    with pytest.raises(ValueError, match="does not split into 4 local"):
        train_step(params, init_train_state(params, run), batch, run)
    with pytest.raises(ValueError, match="local_steps must be >= 1"):
        OptimizerConfig(local_steps=0)


@pytest.mark.parametrize("H", [2, 3, 5, 7])
def test_carried_scalars_follow_jitted_jax(H):
    """``amax / omega``, ``evals / H`` and ``0.9 * ema + 0.1 * evals / H``
    bit for bit as jitted XLA computes them in the worker, whose breaker
    selects the new mean (a ``where``), over many inputs; at H 3 a
    division, and the mean rounded twice or fused the other way, differ
    from it."""
    rng = np.random.default_rng(H)
    amax = (rng.random(3000) * 2).astype(f32)
    evals = rng.integers(H, 40 * H, 3000).astype(f32)
    ema = (rng.random(3000) * 4).astype(f32)
    j_alpha = np.asarray(jax.jit(jax.vmap(lambda a: a / JArmijo().omega))(
        amax))
    j_mean = np.asarray(jax.jit(jax.vmap(lambda e: e / H))(evals))
    j_ema = np.asarray(jax.jit(jax.vmap(
        lambda m, e: jnp.where(e > 0, 0.9 * m + 0.1 * e / H, m)))(
            ema, evals))
    got_alpha = np.array([reciprocal_product(a, 1.2) for a in amax])
    got_mean = np.array([reciprocal_product(e, H) for e in evals])
    got_ema = np.array([local_evals_ema(m, e, H)
                        for m, e in zip(ema, evals)])
    for got, want in ((got_alpha, j_alpha), (got_mean, j_mean),
                      (got_ema, j_ema)):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    assert (amax / f32(1.2) != j_alpha).mean() > 0.1
    if H == 3:
        assert (evals / f32(H) != j_mean).any()
        c = f32(0.1) * (f32(1) / f32(H))
        two = f32(0.9) * ema + evals * c
        other = (np.float64(f32(0.9)) * ema + evals * c).astype(f32)
        assert (two != j_ema).any() and (other != j_ema).any()


def test_jax_int8_ef_memory_truncates_and_the_port_refuses_it():
    """In the JAX trainer int8 EF memory stores the residual with a
    float->int8 convert (core/dcsgd.py:229): every |residual| < 1
    becomes 0, so error feedback is lost (ROADMAP queue 3).  The port
    refuses ``ef_dtype='int8'`` and names single-node CSGD's quantized
    EF."""
    assert np.asarray(jax.jit(lambda x: x.astype(jnp.int8))(
        jnp.asarray([0.7, -0.9, 1.6, -2.5], jnp.float32))).tolist() == \
        [0, 0, 1, -2]
    rng = np.random.default_rng(0)
    g = {"w": jnp.asarray(rng.standard_normal((4, 2048)).astype(f32))}
    spec = {"w": P()}
    comp = JCompressor(gamma=0.01)
    for dt in (jnp.float32, jnp.int8):
        _, new_mem, *_ = jax.jit(shard_map(
            lambda gg, m: jwca(gg, m, jnp.float32(0.1), comp, ("data",)),
            mesh=jax.make_mesh((1,), ("data",)), in_specs=(spec, spec),
            out_specs=(spec, spec, P(), P(), P()),
            axis_names={"data"}))(g, {"w": jnp.zeros((4, 2048), dt)})
        kept = int(jnp.count_nonzero(new_mem["w"]))
        assert (kept > 0.9 * 4 * 2048) if dt == jnp.float32 else kept == 0
    with pytest.raises(ValueError, match="CSGDConfig\\(ef_dtype='int8'\\)"):
        OptimizerConfig(ef_dtype="int8")
    with pytest.raises(ValueError, match="unknown ef_dtype"):
        OptimizerConfig(ef_dtype="float16")


def test_cli_local_steps_and_bf16_memory():
    """``--local-steps 2 --microbatches 2`` and ``--ef-dtype bfloat16``
    through the CLI on the CPU; a mismatched ``--microbatches`` raises
    JAX's error."""
    base = ["--device", "cpu", "--smoke", "--seq-len", str(SEQ),
            "--global-batch", str(BATCH), "--compress-method",
            "block_topk", "--log-every", "1", "--steps", "2"]
    log = train_cli.main(base + ["--local-steps", "2", "--microbatches",
                                 "2", "--ef-dtype", "bfloat16"])
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["n_evals"] >= 1
               and m["grad_sqnorm"] == 0.0 for m in log)
    with pytest.raises(ValueError, match="requires microbatches == "
                                         "local_steps"):
        train_cli.main(base + ["--local-steps", "3"])
    with pytest.raises(ValueError, match="single-node CSGD's quantized"):
        train_cli.main(base + ["--ef-dtype", "int8"])
