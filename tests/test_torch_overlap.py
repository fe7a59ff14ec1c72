"""The overlap transport (``comm/overlap.py``) against the JAX package and
against the port's ``bucketed`` transport.

* ``OverlapConfig``, the trainer config's refusals and the exchange's
  errors word for word against JAX's;
* ``init_overlap_state`` against JAX's: words, dense size and the zero
  payload's effective bytes;
* ``overlap_exchange`` against JAX's in a 1-device ``shard_map`` (jitted,
  as the trainer runs it; JAX decodes with its fault verdicts on, its
  default), two rounds at delay 0 and 1: updates, EF memory, wire and
  effective bytes and the carried state bit for bit, telemetry within 8
  ulp;
* delay 0 against the port's ``bucketed`` bit for bit on 1 and 3 gloo
  workers at per-worker gamma_t, and the delay-1 collectives posted early
  against a late post;
* JAX's warm-up/staleness contract
  (tests/distributed/test_overlap_exchange.py:192-232) on 4 gloo workers;
* the golden delay-1 quadratic (:235-280) on 4 gloo workers.
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

from repro.comm import overlap as jov
from repro.compat import shard_map
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import Compressor as JCompressor
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro_torch.comm import exchange
from repro_torch.comm import overlap as ov
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.models import lm
from repro_torch.utils import tree_flatten

import torch_overlap_workers as workers
import torch_trainer_ref as ref

torch.set_num_threads(2)

f32 = np.float32
SHAPES, STACKED, NAMES = workers.SHAPES, workers.STACKED, workers.NAMES
TEL = ("ef_backlog", "cosine", "decode_error", "eff_gamma")


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# config, state and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_chunks=0), dict(n_chunks=-2),
                                dict(delay=2), dict(delay=-1)],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_overlap_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as e:
        jov.OverlapConfig(**kw)
    with pytest.raises(ValueError) as t:
        ov.OverlapConfig(**kw)
    assert str(t.value) == str(e.value)
    assert dataclasses.asdict(ov.OverlapConfig()) == \
        dataclasses.asdict(jov.OverlapConfig())


def _jax_error(kw, micro=1):
    """JAX's message for ``kw``: from its OptimizerConfig, else from its
    build_train_step on a 1-device mesh."""
    with pytest.raises(ValueError) as e:
        jrun = JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(**kw))
        jbuild_train_step(None, jrun, jax.make_mesh((1,), ("data",)))
    return str(e.value)


def _port_error(kw, micro=1):
    with pytest.raises(ValueError) as e:
        RunConfig(model=ref.get_smoke_config(ref.ARCH),
                  shape=ShapeConfig(ref.SEQ, ref.BATCH), microbatches=micro,
                  optimizer=OptimizerConfig(**kw))
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(kind="acgd"), dict(kind="sls"), dict(kind="sgd"),
    dict(kind="dense"), dict(downlink="compressed"),
    dict(downlink="compressed", kind="acgd"),
    dict(shard_local_topk=True)],
    ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_config_refusals_match_jax(kw):
    kw = dict(kw, transport="overlap")
    assert _port_error(kw) == _jax_error(kw)


def test_trainer_takes_what_jax_takes():
    """Local steps, bf16 EF memory, microbatches and an adaptive budget
    compose with overlap, in both packages."""
    for kw, micro in ((dict(kind="nonadaptive"), 1),
                      (dict(local_steps=2), 2),
                      (dict(ef_dtype="bfloat16"), 2)):
        RunConfig(model=ref.get_smoke_config(ref.ARCH),
                  shape=ShapeConfig(ref.SEQ, ref.BATCH), microbatches=micro,
                  optimizer=OptimizerConfig(
                      transport="overlap",
                      compressor=Compressor(gamma=0.04, max_gamma=0.1), **kw))
        jbuild_train_step(None, JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(
                transport="overlap",
                compressor=JCompressor(gamma=0.04, max_gamma=0.1), **kw)),
            jax.make_mesh((1,), ("data",)))


def _lm_geometry():
    params = lm.init_params(ref.get_smoke_config(ref.ARCH), seed=0)
    return ([tuple(p.shape) for p in tree_flatten(params)[0]],
            tree_flatten(lm.stacked_mask(params))[0])


STATE_COMPS = [
    dict(gamma=0.01, method="block_topk"),
    dict(gamma=0.05, method="block_topk", block=512, min_compress_size=64,
         value_bits=8),
    dict(gamma=0.04, max_gamma=0.1, method="block_topk", value_bits=8),
    dict(gamma=0.01, max_gamma=0.05, method="topk", value_bits=16),
    dict(gamma=0.01, method="none")]


@pytest.mark.parametrize("kw", STATE_COMPS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_init_overlap_state_matches_jax(kw):
    comp, jcomp = Compressor(**kw), JCompressor(**kw)
    for shapes, stacked in ((SHAPES, STACKED), _lm_geometry()):
        st = ov.init_overlap_state(shapes, stacked, comp)
        jst = jov.init_overlap_state(shapes, stacked, jcomp)
        assert st.payload.dtype == torch.int32 and not st.payload.any()
        assert tuple(st.payload.shape) == jst.payload.shape
        assert st.dense.dtype == torch.float32 and not st.dense.any()
        assert tuple(st.dense.shape) == jst.dense.shape
        assert isinstance(st.eff_wire, np.float32)
        assert st.eff_wire.view(np.int32) == \
            np.asarray(jst.eff_wire).view(np.int32)
        assert st.seeded == np.asarray(jst.seeded) == 0.0


def test_exchange_errors_match_jax():
    """A carried state of another geometry, and a stateful transport
    without its context (or a stateless one with one), word for word."""
    comp, jcomp = Compressor(gamma=0.05, method="block_topk"), \
        JCompressor(gamma=0.05, method="block_topk")
    g = workers.exchange_inputs(1)
    cfg = ov.OverlapConfig(delay=0)
    good = ov.init_overlap_state(SHAPES, STACKED, comp)
    jgood = jov.init_overlap_state(SHAPES, STACKED, jcomp)
    for field, n in (("payload", 7), ("dense", 3)):
        st = dataclasses.replace(good, **{field: getattr(good, field)[:n]})
        jst = dataclasses.replace(jgood,
                                  **{field: getattr(jgood, field)[:n]})
        with pytest.raises(ValueError) as e:
            _jax_fn(tuple(jcomp.__dict__.items()), 0, 1, False)(
                g, g, jnp.float32(0.1), jnp.float32(0.0), jst)
        with pytest.raises(ValueError) as t:
            worker_compress_aggregate(to_torch(g), to_torch(g), f32(0.1),
                                      comp, transport="overlap",
                                      transport_ctx=ov.OverlapCtx(cfg, st))
        assert str(t.value) == str(e.value)
    for transport, ctx in (("overlap", None), ("bucketed", object())):
        with pytest.raises(ValueError) as e:
            jwca(None, None, None, jcomp, ("data",), transport=transport,
                 transport_ctx=ctx)
        with pytest.raises(ValueError) as t:
            worker_compress_aggregate(None, None, None, comp,
                                      transport=transport,
                                      transport_ctx=ctx)
        assert str(t.value) == str(e.value)


# ---------------------------------------------------------------------------
# the exchange against JAX's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fn(comp_items, delay, n_chunks, adaptive):
    """JAX's overlap exchange in a 1-device shard_map, jitted:
    ``(g, m, eta, gamma_t, state) -> (updates, memory, wire, eff,
    telemetry, new state)``."""
    comp = JCompressor(**dict(comp_items))
    cfg = jov.OverlapConfig(n_chunks=n_chunks, delay=delay)
    mesh = jax.make_mesh((1,), ("data",))
    spec = {n: P() for n in NAMES}
    smask = dict(zip(NAMES, STACKED))
    f = shard_map(
        lambda g, m, e, gt, st: jwca(
            g, m, e, comp, ("data",), stacked_mask=smask,
            gamma_t=gt if adaptive else None, transport="overlap",
            transport_ctx=jov.OverlapCtx(cfg, st)),
        mesh=mesh, in_specs=(spec, spec, P(), P(), P()),
        out_specs=(spec, spec, P(), P(), P(), P()), axis_names={"data"})
    return jax.jit(f)


#: 32-bit and 8-bit values, and an adaptive budget at gamma_t 0.04 then
#: 0.07 with bf16 EF memory
EXCHANGE_CASES = {
    "v32": (dict(gamma=0.05, method="block_topk", block=512,
                 min_compress_size=64), "float32", None),
    "v8": (dict(gamma=0.05, method="block_topk", block=512,
                min_compress_size=64, value_bits=8), "float32", None),
    "adaptive-v8-bf16-ef": (dict(gamma=0.04, max_gamma=0.1,
                                 method="block_topk", min_compress_size=64,
                                 value_bits=8), "bfloat16", (0.04, 0.07)),
}


def _bits32(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("case", EXCHANGE_CASES)
def test_overlap_exchange_matches_jax(case, delay):
    kw, ef_dtype, gammas = EXCHANGE_CASES[case]
    comp = Compressor(**kw)
    jfn = _jax_fn(tuple(JCompressor(**kw).__dict__.items()), delay, 3,
                  gammas is not None)
    cfg = ov.OverlapConfig(n_chunks=3, delay=delay)
    g1, m = workers.exchange_inputs(11, 12)
    g2 = workers.exchange_inputs(13)
    jdt = jnp.bfloat16 if ef_dtype == "bfloat16" else jnp.float32
    jm = {n: jnp.asarray(v).astype(jdt) for n, v in m.items()}
    tm = {n: torch.from_numpy(v).to(getattr(torch, ef_dtype))
          for n, v in m.items()}
    st = ov.init_overlap_state(SHAPES, STACKED, comp)
    jst = jov.init_overlap_state(SHAPES, STACKED, JCompressor(**kw))
    smask = dict(zip(NAMES, STACKED))
    for rnd, g in enumerate((g1, g2)):
        gt = f32(gammas[rnd]) if gammas is not None else None
        j_upd, jm, j_wire, j_eff, j_tel, jst = jfn(
            {n: jnp.asarray(v) for n, v in g.items()}, jm, jnp.float32(0.3),
            jnp.float32(gt if gt is not None else 0.0), jst)
        t_upd, tm, t_wire, t_eff, t_tel, st = worker_compress_aggregate(
            to_torch(g), tm, f32(0.3), comp, stacked_mask=smask,
            gamma_t=gt, transport="overlap",
            transport_ctx=ov.OverlapCtx(cfg, st))
        where = f"{case} delay {delay} round {rnd}"
        for n in NAMES:
            np.testing.assert_array_equal(_bits32(j_upd[n]),
                                          _bits32(t_upd[n].numpy()),
                                          err_msg=f"{where} update {n}")
            np.testing.assert_array_equal(
                _bits32(np.asarray(jm[n]).astype(np.float32)),
                _bits32(tm[n].float().numpy()), err_msg=f"{where} mem {n}")
            assert tm[n].dtype == getattr(torch, ef_dtype)
            if delay == 1 and rnd == 0:
                assert not t_upd[n].any(), f"{where}: the warm-up update"
        assert (float(t_wire), float(t_eff)) == \
            (float(j_wire), float(j_eff)), where
        for f in TEL:
            np.testing.assert_array_max_ulp(
                np.float32(getattr(j_tel, f)),
                np.float32(getattr(t_tel, f)), maxulp=8)
        np.testing.assert_array_equal(
            np.asarray(jst.payload).view(np.int32), st.payload.numpy(),
            err_msg=f"{where} carried payload")
        np.testing.assert_array_equal(_bits32(jst.dense),
                                      _bits32(st.dense.numpy()))
        assert _bits32(st.eff_wire) == _bits32(jst.eff_wire), where
        assert st.seeded == np.asarray(jst.seeded) == 1.0
        jm = {n: jnp.asarray(np.asarray(v)) for n, v in jm.items()}
        jst = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), jst)


# ---------------------------------------------------------------------------
# delay 0 against bucketed; the early start; several workers
# ---------------------------------------------------------------------------

def _same(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=what)
    else:
        assert _bits32(a) == _bits32(b), (what, a, b)


@pytest.mark.parametrize("W", [1, 3])
def test_delay0_equals_bucketed_and_early_start_equals_late(W):
    got = {0: workers.delay0_and_early_start(0, 1)} if W == 1 else \
        workers.spawn(workers.delay0_and_early_start, W)
    for rank, res in got.items():
        for nc in (1, 3):
            for rnd, (b, o, state) in enumerate(res[f"delay0-nc{nc}"]):
                # updates, memory, wire, eff and telemetry bit for bit
                _same(b, o, f"rank {rank} nc {nc} round {rnd}")
                assert state[2] == o[3] and state[3] == 1.0
        early, late = res["early-late"]
        _same(early, late, f"rank {rank} early vs late")
    if W > 1:
        # per-worker gamma_t: different counts, different effective bytes
        effs = [got[r]["delay0-nc1"][0][0][3] for r in range(W)]
        assert effs == sorted(effs) and effs[0] < effs[-1]
        for r in range(1, W):
            _same(got[0]["delay0-nc1"][0][0][0], got[r]["delay0-nc1"][0][0][0],
                  f"the mean update on rank {r}")


@pytest.fixture(scope="module")
def four_workers():
    """Both 4-worker checks from one set of worker processes."""
    return workers.spawn(workers.four_worker_checks, 4)


def test_delay1_warmup_and_staleness_on_four_workers(four_workers):
    """Round 1 (the zero carried payload): a zero update, EF memory equal
    to bucketed's, the static wire bytes and the zero payload's effective
    bytes.  Round 2: the applied aggregate IS round 1's bucketed mean,
    EF memory equal to bucketed round 2's, effective bytes round 1's."""
    for rank, (r, _) in four_workers.items():
        b1, o1, b2, o2 = r["buck1"], r["ov1"], r["buck2"], r["ov2"]
        for n in NAMES:
            assert not o1[0][n].any(), (rank, n)
        _same(b1[1], o1[1], f"rank {rank} warm-up EF")
        assert o1[2] == b1[2] and o1[3] == r["zero_eff"] <= b1[3]
        assert r["seeded1"] == 1.0
        _same(b1[0], o2[0], f"rank {rank} delay-1 aggregate")
        _same(b2[1], o2[1], f"rank {rank} round-2 EF")
        assert o2[3] == b1[3] and o2[2] == b2[2]
    effs = [four_workers[r][0]["buck1"][3] for r in range(4)]
    assert effs == sorted(effs) and effs[0] < effs[-1]


def test_golden_delay1_quadratic_on_four_workers(four_workers):
    """tests/distributed/test_overlap_exchange.py:235-280 on 4 gloo
    workers: after T = 120 steps the delay-1 trajectory's suboptimality
    stays within 5% (+ 5e-4) of the synchronous bucketed one's."""
    W = 4
    got = {r: four_workers[r][1] for r in range(W)}
    for r in range(1, W):
        _same(got[0], got[r], f"x on rank {r}")
    a, b = (x.astype(np.float64) for x in workers.quadratic_data(W))
    x_star = b.mean(0) / a.mean(0)

    def f_global(x):
        return float(np.mean(np.sum(0.5 * a * x[None] ** 2 - b * x[None],
                                    axis=1)))

    gap_sync = f_global(got[0]["bucketed"].astype(np.float64)) \
        - f_global(x_star)
    gap_stale = f_global(got[0]["overlap"].astype(np.float64)) \
        - f_global(x_star)
    assert gap_sync >= 0 and gap_stale >= 0
    assert gap_stale <= 1.05 * gap_sync + 5e-4, (gap_stale, gap_sync)
    assert not np.array_equal(got[0]["bucketed"], got[0]["overlap"])
