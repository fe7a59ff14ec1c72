"""Single-node CSGD-ASSS (paper Algorithm 2) of the port against the JAX
package: the dense compressors, the int8 EF memory, the optimizer and its
baselines, the paper nets, and the paper's Fig. 4 verdicts.

The JAX side runs jitted, as its callers run it (``jax.jit(opt.step)``
outside any mesh, as tests/test_csgd.py does); its ``block_topk`` path
reaches the Pallas kernels in interpret mode.  The port runs its plain
versions on the CPU.  Inputs are numpy, from fixed seeds.

Tolerances, each with its reason:

* compress_dense, the int8 EF scale words and q, the data generators:
  bit-exact;
* CSGD on the smoke LM: alpha and n_evals equal, loss rel 1e-5,
  parameters and EF memory within 1e-5 of the leaf's max|p| — XLA and
  PyTorch sum the forward and backward passes in other orders, and an
  entry an ulp away can cross its block's threshold;
* the d=256 regression: alpha and n_evals equal, loss rel 1e-5, iterates
  within 1e-5 of max|w| (the same reduction-order argument; the int8 EF
  memory may move one quantization step, 1/127 of its block's max);
* telemetry ratios rel 1e-4 (f32 sums over leaves in another order);
* the paper nets' loss rel 1e-5 (matmul and convolution sum orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import paper_models as jpm
from repro.core import ArmijoConfig as JArmijo
from repro.core import Compressor as JCompressor
from repro.core import CSGDConfig as JCSGDConfig
from repro.core import NonAdaptiveCSGD as JNonAdaptive
from repro.core import SGD as JSGD
from repro.core import SLS as JSLS
from repro.core import csgd_asss as jcsgd_asss
from repro.core import error_feedback as jef
from repro.data import synthetic as jsyn
from repro.models import build_model
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.configs import paper_models as pm
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import csgd_state_to_torch, to_numpy, to_torch
from repro_torch.core import error_feedback as ef
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.baselines import SGD, SLS, NonAdaptiveCSGD
from repro_torch.core.compression import Compressor, tree_wire_bytes
from repro_torch.core.csgd import CSGDConfig, csgd_asss
from repro_torch.data import synthetic as syn
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.utils import tree_leaves

torch.set_num_threads(2)

ARCH = "paper-lm-100m"
N, D = 512, 256


def _quadratic():
    A, b, _ = jsyn.interpolated_regression(N, D, feature_std=1.0, seed=0)
    tA, tb, _ = syn.interpolated_regression(N, D, feature_std=1.0, seed=0)

    def jloss(w, idx):
        return jnp.mean((A[idx] @ w - b[idx]) ** 2)

    def tloss(w, idx):
        return ((tA[idx] @ w - tb[idx]) ** 2).mean()

    return jloss, tloss


def _leaf_close(a, b, scale, what, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rel * max(scale, 1e-30), \
        f"{what}: {np.abs(a - b).max()} vs scale {scale}"


def _dense_memory(mem):
    """A JAX or port EF memory leaf (plain, bf16 or QuantizedEF) as f32
    numpy."""
    if hasattr(mem, "q"):
        q, s = np.asarray(to_numpy(mem.q) if torch.is_tensor(mem.q)
                          else mem.q), \
            np.asarray(to_numpy(mem.scale) if torch.is_tensor(mem.scale)
                       else mem.scale)
        return (q.astype(np.float32) * s).reshape(-1)[
            :int(np.prod(mem.shape))].reshape(mem.shape)
    if torch.is_tensor(mem):
        return mem.float().numpy()
    return np.asarray(mem.astype(jnp.float32))


# ---------------------------------------------------------------------------
# compressors and EF storage, bit-exact
# ---------------------------------------------------------------------------

def _flat_leaves():
    """Leaves whose flat blocks cross layer rows, with a padded tail,
    ties and a zero block."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1500)).astype(np.float32)
    t = np.round(rng.standard_normal((2, 2100)) * 2).astype(np.float32)
    t[0, :1100] = 0.0
    return {"rows": x, "ties": t, "small": x[0, :700].copy()}


@pytest.mark.parametrize("case", [
    dict(method="block_topk", gamma=0.01),
    dict(method="block_topk", gamma=0.05),
    dict(method="topk", gamma=0.01),
    dict(method="topk", gamma=0.02, value_bits=8),
    dict(method="topk", gamma=0.02, value_bits=4),
    dict(method="topk", gamma=0.02, value_bits=16),
    dict(method="none", gamma=0.01),
], ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_compress_dense_matches_jax(case):
    jc, tc = JCompressor(**case), Compressor(**case)
    for name, x in _flat_leaves().items():
        js, jr = jax.jit(jc.compress_dense)(jnp.asarray(x))
        ts, tr = tc.compress_dense(torch.from_numpy(x))
        np.testing.assert_array_equal(np.asarray(js), ts.numpy(), name)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(), name)
        if case.get("value_bits", 32) == 32:
            np.testing.assert_array_equal((ts + tr).numpy(), x)


def test_tree_wire_bytes_matches_jax():
    from repro.core.compression import tree_wire_bytes as jtwb
    tree = {"a": np.zeros((3, 1500), np.float32),
            "b": [np.zeros(700, np.float32), np.zeros((2, 4, 512),
                                                      np.float32)]}
    for kw in (dict(method="block_topk"), dict(method="topk"),
               dict(method="topk", value_bits=4), dict(method="none")):
        assert tree_wire_bytes(to_torch(tree), Compressor(**kw)) == \
            jtwb(jax.tree.map(jnp.asarray, tree), JCompressor(**kw))


def test_int8_ef_scale_matches_jitted_jax():
    """The scale words follow the jitted form (XLA's fma with the f32
    reciprocal of 127); q and the dequantized memory are bit-exact."""
    rng = np.random.default_rng(9)
    m = (rng.standard_normal(1000 * 256 + 77) * 1e-3).astype(np.float32)
    m[:256] = 0.0                                # an all-zero block
    jq = jax.jit(jef.quantize_ef)(jnp.asarray(m))
    tq = ef.quantize_ef(torch.from_numpy(m))
    assert tq.shape == jq.shape
    np.testing.assert_array_equal(np.asarray(jq.scale).view(np.uint32),
                                  tq.scale.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jq.q), tq.q.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jef.dequantize_ef)(jq)),
        ef.dequantize_ef(tq).numpy())
    zero = ef.init_ef_quantized({"w": torch.zeros(3, 300)})["w"]
    jzero = jef.init_ef_quantized({"w": jnp.zeros((3, 300))})["w"]
    np.testing.assert_array_equal(np.asarray(jzero.scale),
                                  zero.scale.numpy())


@pytest.mark.parametrize("gamma", [0.02, 0.05])
def test_gamma_is_the_compressors_at_init_and_after_a_step(gamma):
    """The fixed schedule: state.gamma and aux.gamma are the compressor's
    gamma, as in the JAX package."""
    comp = dict(gamma=gamma, min_compress_size=1)
    jloss, tloss = _quadratic()
    idx = np.arange(32)
    jopt = jcsgd_asss(JCSGDConfig(compressor=JCompressor(**comp)))
    topt = csgd_asss(CSGDConfig(compressor=Compressor(**comp)))
    js, ts = jopt.init(jnp.zeros(D)), topt.init(torch.zeros(D))
    assert float(ts.gamma) == float(js.gamma) == np.float32(gamma)
    _, js, ja = jax.jit(lambda w, s: jopt.step(
        lambda ww: jloss(ww, jnp.asarray(idx)), w, s))(jnp.zeros(D), js)
    _, ts, ta = topt.step(lambda ww: tloss(ww, torch.from_numpy(idx)),
                          torch.zeros(D), ts)
    assert float(ta.gamma) == float(ja.gamma) == np.float32(gamma)
    assert float(ts.gamma) == float(js.gamma)


# ---------------------------------------------------------------------------
# the optimizer on the d=256 regression, 20 steps
# ---------------------------------------------------------------------------

def _drive(jopt, topt, steps=20):
    jloss, tloss = _quadratic()

    @jax.jit
    def jstep(w, s, idx):
        return jopt.step(lambda ww: jloss(ww, idx), w, s)

    w, tw = jnp.zeros(D), torch.zeros(D)
    js, ts = jopt.init(w), topt.init(tw)
    rng = np.random.default_rng(0)
    for t in range(steps):
        idx = rng.integers(0, N, 32)
        w, js, ja = jstep(w, js, jnp.asarray(idx))
        tidx = torch.from_numpy(idx)
        tw, ts, ta = topt.step(lambda ww: tloss(ww, tidx), tw, ts)
        np.testing.assert_allclose(float(ta.loss), float(ja.loss),
                                   rtol=1e-5, err_msg=f"step {t}")
        if hasattr(ja, "alpha"):
            assert float(ta.alpha) == float(ja.alpha), t
            assert int(ta.n_evals) == int(ja.n_evals), t
        _leaf_close(np.asarray(w), tw.numpy(),
                    float(jnp.max(jnp.abs(w))), f"step {t} w")
    return js, ts, ja, ta


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_scaling=False),
    dict(momentum=0.9),
    dict(ef_dtype="bfloat16"),
    dict(ef_dtype="int8"),
    dict(armijo=None, eta=0.01),
    dict(value_bits=8),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_csgd_regression_matches_jax(kw):
    kw = dict(kw)
    comp = dict(gamma=0.04, min_compress_size=1,
                value_bits=kw.pop("value_bits", 32))
    arm = dict(sigma=0.1, a_scale=0.3)
    jarm = kw.pop("armijo", JArmijo(**arm))
    tarm = None if jarm is None else ArmijoConfig(**arm)
    js, ts, ja, ta = _drive(
        jcsgd_asss(JCSGDConfig(armijo=jarm, compressor=JCompressor(**comp),
                               **kw)),
        csgd_asss(CSGDConfig(armijo=tarm, compressor=Compressor(**comp),
                             **kw)))
    scale = float(np.abs(_dense_memory(js.memory)).max())
    step = scale / 127 if kw.get("ef_dtype") == "int8" else 0.0
    assert np.abs(_dense_memory(js.memory)
                  - _dense_memory(ts.memory)).max() <= 1e-5 * scale + step
    assert float(ts.alpha_prev) == float(js.alpha_prev)
    assert float(ts.n_evals_ema) == float(js.n_evals_ema)
    assert float(ts.gamma) == float(js.gamma)
    assert float(ta.eta) == float(ja.eta)
    assert float(ta.wire_bytes) == float(ja.wire_bytes)
    assert float(ts.cum_eff_bytes) == float(js.cum_eff_bytes)
    for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma"):
        np.testing.assert_allclose(float(getattr(ta.telemetry, f)),
                                   float(getattr(ja.telemetry, f)),
                                   rtol=1e-4, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["nonadaptive", "sgd", "sgd-momentum",
                                  "sls"])
def test_baselines_regression_match_jax(name):
    comp = dict(gamma=0.05, min_compress_size=1)
    jopt, topt = {
        "nonadaptive": (JNonAdaptive(eta=0.01, compressor=JCompressor(**comp)),
                        NonAdaptiveCSGD(eta=0.01,
                                        compressor=Compressor(**comp))),
        "sgd": (JSGD(eta=0.01), SGD(eta=0.01)),
        "sgd-momentum": (JSGD(eta=0.005, beta=0.9), SGD(eta=0.005, beta=0.9)),
        "sls": (JSLS(), SLS()),
    }[name]
    js, ts, _, _ = _drive(jopt, topt)
    if name == "nonadaptive":
        _leaf_close(js.memory, ts.memory.numpy(),
                    float(jnp.max(jnp.abs(js.memory))), "memory")
    if name == "sls":
        assert float(ts.alpha_prev) == float(js.alpha_prev)


def test_csgd_state_converts_mid_run():
    """A JAX CSGDState with int8 memory and velocity, carried into the
    port after 3 steps, continues as the JAX run does."""
    jloss, tloss = _quadratic()
    kw = dict(compressor=dict(gamma=0.04, min_compress_size=1),
              ef_dtype="int8", momentum=0.5)
    jopt = jcsgd_asss(JCSGDConfig(
        compressor=JCompressor(**kw["compressor"]), ef_dtype="int8",
        momentum=0.5))
    topt = csgd_asss(CSGDConfig(
        compressor=Compressor(**kw["compressor"]), ef_dtype="int8",
        momentum=0.5))
    step = jax.jit(lambda w, s, idx: jopt.step(lambda ww: jloss(ww, idx),
                                               w, s))
    w = jnp.zeros(D)
    js = jopt.init(w)
    rng = np.random.default_rng(1)
    for _ in range(3):
        w, js, _ = step(w, js, jnp.asarray(rng.integers(0, N, 32)))
    ts = csgd_state_to_torch(jax.tree.map(np.asarray, js))
    assert isinstance(ts.memory, ef.QuantizedEF)
    np.testing.assert_array_equal(ts.memory.q.numpy(),
                                  np.asarray(js.memory.q))
    idx = rng.integers(0, N, 32)
    w2, js2, ja = step(w, js, jnp.asarray(idx))
    tw2, ts2, ta = topt.step(
        lambda ww: tloss(ww, torch.from_numpy(idx)),
        torch.from_numpy(np.array(w)), ts)
    assert float(ta.alpha) == float(ja.alpha)
    assert ts2.step == int(js2.step) == 4
    _leaf_close(np.asarray(w2), tw2.numpy(), float(jnp.max(jnp.abs(w2))),
                "w after the converted step")


# ---------------------------------------------------------------------------
# the slice as a whole: CSGD block_topk on paper-lm-100m's smoke variant
# ---------------------------------------------------------------------------

def _assert_tree_close(jtree, ttree, ptree, what):
    """|jax - torch| <= 1e-5 * max|p| per leaf, p the parameter leaf."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            _assert_tree_close(v, ttree[k], ptree[k], f"{what}/{k}")
            continue
        _leaf_close(v, ttree[k].detach().numpy(),
                    float(np.abs(np.asarray(ptree[k])).max()), f"{what}/{k}")


def test_csgd_lm_block_topk_matches_jax():
    """Three CSGD-ASSS steps of the 2-layer smoke LM (d_model 128) with
    ``block_topk``: the compress_dense kernel path, flat blocks across
    layer rows, on every compressed leaf."""
    model = build_model(jax_smoke_config(ARCH))
    cfg = get_smoke_config(ARCH)
    jcfg = JCSGDConfig(armijo=JArmijo(), compressor=JCompressor(
        gamma=0.01, method="block_topk"))
    tcfg = CSGDConfig(armijo=ArmijoConfig(), compressor=Compressor(
        gamma=0.01, method="block_topk"))
    jopt, topt = jcsgd_asss(jcfg), csgd_asss(tcfg)

    @jax.jit
    def jstep(p, s, tokens):
        return jopt.step(lambda q: model.loss(q, {"tokens": tokens})[0],
                         p, s)

    params = model.init(jax.random.PRNGKey(0))
    tparams = to_torch(jax.tree.map(np.asarray, params))
    js, ts = jopt.init(params), topt.init(tparams)
    pipe = syn.TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                             global_batch=4)
    ops.reset_launch_counts()
    for step in range(3):
        batch = pipe.batch(step)
        params, js, ja = jstep(params, js, jnp.asarray(batch["tokens"]))
        tparams, ts, ta = topt.step(lambda p: lm.loss_fn(p, batch, cfg),
                                    tparams, ts)
        np.testing.assert_allclose(float(ta.loss), float(ja.loss),
                                   rtol=1e-5)
        assert float(ta.alpha) == float(ja.alpha)
        assert int(ta.n_evals) == int(ja.n_evals)
        assert float(ta.wire_bytes) == float(ja.wire_bytes)
        np.testing.assert_allclose(float(ta.telemetry.ef_backlog),
                                   float(ja.telemetry.ef_backlog),
                                   rtol=1e-4)
        _assert_tree_close(params, tparams, params, f"step {step} params")
        _assert_tree_close(js.memory, ts.memory, params,
                           f"step {step} memory")
    # the CPU tensors took the plain versions: no kernel was launched
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the paper nets and their data
# ---------------------------------------------------------------------------

def test_paper_data_bit_identical():
    jA, jb, jx = jsyn.interpolated_regression(64, 32, seed=3)
    tA, tb, tx = syn.interpolated_regression(64, 32, seed=3)
    for j, t in ((jA, tA), (jb, tb), (jx, tx)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    ja, jbb = jsyn.regression_batch(jA, jb, 8, step=4, seed=2)
    ta, tbb = syn.regression_batch(tA, tb, 8, step=4, seed=2)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jbb), tbb.numpy())
    for image in (True, False):
        jxx, jy = jsyn.teacher_classification(16, n_classes=10, seed=1,
                                              image=image)
        txx, ty = syn.teacher_classification(16, n_classes=10, seed=1,
                                             image=image)
        np.testing.assert_array_equal(np.asarray(jxx), txx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        jbt = jsyn.class_batch(jxx, jy, 4, step=2, seed=5)
        tbt = syn.class_batch(txx, ty, 4, step=2, seed=5)
        np.testing.assert_array_equal(np.asarray(jbt["x"]),
                                      tbt["x"].numpy())
        np.testing.assert_array_equal(np.asarray(jbt["y"]),
                                      tbt["y"].numpy())


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_paper_net_loss_and_csgd_step_match_jax(kind):
    """The nets' loss at JAX's weights, and one CSGD-ASSS step with
    ``block_topk`` on them (HWIO kernels flatten as in JAX)."""
    jcfg = jpm.PaperNetConfig(name="t", kind=kind, n_classes=10,
                              widths=(64,), channels=(8, 16))
    tcfg = pm.PaperNetConfig(name="t", kind=kind, n_classes=10,
                             widths=(64,), channels=(8, 16))
    x, y = jsyn.teacher_classification(8, n_classes=10, seed=0,
                                       image=kind == "cnn")
    jparams = jpm.init_net(jcfg, jax.random.PRNGKey(0))
    tparams = to_torch(jax.tree.map(np.asarray, jparams))
    jbatch = {"x": x, "y": y}
    tbatch = {"x": torch.from_numpy(np.asarray(x)),
              "y": torch.from_numpy(np.asarray(y))}
    np.testing.assert_allclose(
        float(pm.net_loss(tcfg, tparams, tbatch)),
        float(jax.jit(lambda p: jpm.net_loss(jcfg, p, jbatch))(jparams)),
        rtol=1e-5)
    comp = dict(gamma=0.05, method="block_topk")
    jopt = jcsgd_asss(JCSGDConfig(compressor=JCompressor(**comp)))
    topt = csgd_asss(CSGDConfig(compressor=Compressor(**comp)))
    jp, _, ja = jax.jit(lambda p, s: jopt.step(
        lambda q: jpm.net_loss(jcfg, q, jbatch), p, s))(
            jparams, jopt.init(jparams))
    tp, _, ta = topt.step(lambda q: pm.net_loss(tcfg, q, tbatch), tparams,
                          topt.init(tparams))
    assert float(ta.alpha) == float(ja.alpha)
    for jl, tl in zip(jp, tp):
        for k in jl:
            _leaf_close(jl[k], tl[k].numpy(),
                        float(jnp.max(jnp.abs(jl[k]))), f"{kind}/{k}")
    assert len(pm.init_net(pm.CNN_CONFIG, seed=0)) == 4
    assert pm.init_net(pm.MLP_CONFIG, seed=0)[0]["w"].shape == (3072, 512)


# ---------------------------------------------------------------------------
# the paper's claims, in the port alone
# ---------------------------------------------------------------------------

def _trajectory(use_scaling, gamma, a_scale, steps):
    """tests/test_golden_convergence.py's _trajectory, in the port."""
    _, tloss = _quadratic()
    opt = csgd_asss(CSGDConfig(
        armijo=ArmijoConfig(sigma=0.1, a_scale=a_scale),
        compressor=Compressor(gamma=gamma, min_compress_size=1),
        use_scaling=use_scaling))
    w = torch.zeros(D)
    st = opt.init(w)
    rng = np.random.default_rng(0)
    sup_norm, loss = 0.0, None
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, N, 32))
        w, st, aux = opt.step(lambda ww: tloss(ww, idx), w, st)
        loss = float(aux.loss)
        wn = float(torch.linalg.norm(w))
        sup_norm = max(sup_norm, wn if np.isfinite(wn) else np.inf)
        if not np.isfinite(loss) or loss > 1e10:
            break
    return loss, sup_norm


def test_fig4_scaling_converges_with_bounded_iterates():
    loss, sup_norm = _trajectory(True, 0.04, 0.3, 400)
    assert np.isfinite(loss) and loss < 0.1, loss
    assert sup_norm < 50.0, sup_norm


def test_fig4_no_scaling_diverges():
    loss, sup_norm = _trajectory(False, 0.01, 1.0, 150)
    assert (not np.isfinite(loss)) or loss > 100.0 or sup_norm > 1e3, \
        (loss, sup_norm)


def test_fig4_scaling_flag_alone_separates():
    loss_s, sup_s = _trajectory(True, 0.02, 0.3, 250)
    loss_u, sup_u = _trajectory(False, 0.02, 1.0, 250)
    assert np.isfinite(loss_s) and loss_s < 5.0 and sup_s < 50.0, \
        (loss_s, sup_s)
    assert (not np.isfinite(loss_u)) or loss_u > 10.0 * max(loss_s, 1e-6) \
        or sup_u > 20.0 * sup_s, (loss_u, sup_u)


def test_dcsgd_one_worker_equals_csgd():
    """tests/test_distributed.py's DCSGD == CSGD check inside the port:
    the one-worker data-parallel train step with ``topk`` against the
    single-node optimizer on the same batch.  DCSGD compresses each
    stacked leaf per layer, CSGD the whole leaf, so the two differ only
    where the selections do."""
    created = exchange.init_process_group(torch.device("cpu"))
    try:
        cfg = get_smoke_config(ARCH)
        comp = Compressor(gamma=0.1, min_compress_size=64)
        arm = ArmijoConfig()
        run = RunConfig(model=cfg, shape=ShapeConfig(32, 2),
                        optimizer=OptimizerConfig(armijo=arm,
                                                  compressor=comp))
        params = lm.init_params(cfg, seed=0)
        batch = syn.TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2).batch(0)
        p_dist, _, metrics = train_step(params, init_train_state(params,
                                                                 run),
                                        batch, run)
        opt = csgd_asss(CSGDConfig(armijo=arm, compressor=comp))
        p_ref, _, aux = opt.step(lambda p: lm.loss_fn(p, batch, cfg),
                                 params, opt.init(params))
    finally:
        if created:
            dist.destroy_process_group()
    worst = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(p_dist), tree_leaves(p_ref)))
    assert worst < 5e-3, worst
    assert abs(metrics["loss"] - float(aux.loss)) < 1e-4
