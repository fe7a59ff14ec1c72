"""The compressed downlink (``comm/downlink.py``) against the JAX package:
the server round ``apply_downlink``, the launch-free decode
``roundtrip_rows``, the plan and byte helpers, the trainer with
``downlink="compressed"``, its errors, two gloo workers and resume.

``apply_downlink`` is pure and needs no mesh: the JAX side runs it under
``jax.jit``, as the trainer runs it (jitted XLA computes the absmax
scale of 8- and 4-bit values as a fused multiply-add, eager JAX
divides; ROADMAP queue 3).  Bit for bit: the decoded updates, the server
memory, the byte counts and ``roundtrip_rows``.  The trainer against the
reference round of tests/torch_trainer_ref.py, at the tolerances stated
there; bytes and ``cum_effective_wire_bytes`` exact.
"""
import dataclasses
import functools
import json
import multiprocessing as mp
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm import downlink as jdl
from repro.comm import wire as jwire
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import Compressor as JCompressor
from repro.core.dcsgd import worker_compress_aggregate as jwca
from repro.core.gamma import GammaControllerConfig as JGammaCfg
from repro.launch.train_step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.comm import downlink as dl
from repro_torch.comm import exchange
from repro_torch.comm import transport as ttransport
from repro_torch.comm import wire
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.core.leafmath import compress_leaf
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.utils import tree_flatten

import torch_trainer_ref as ref

torch.set_num_threads(2)

f32 = np.float32
#: leaves in flat order: a stacked leaf, a flat one, two dense ones and
#: one past 65,536 entries (32-bit flat indices under topk)
SHAPES = [(2, 2048), (3000,), (50,), (40,), (70000,)]
STACKED = [True, False, False, False, False]


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _updates(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(f32) for s in SHAPES]


#: (compressor, downlink gamma): both methods at 32, 8 and 4 bits, and
#: ragged rows (block-local at k_b_t 41 of 102, flat at 16 bits)
CASES = [
    (dict(gamma=0.05, method="topk"), 0.05),
    (dict(gamma=0.05, method="block_topk"), 0.05),
    (dict(gamma=0.05, method="block_topk", value_bits=8), 0.05),
    (dict(gamma=0.05, method="topk", value_bits=4), 0.05),
    (dict(gamma=0.04, method="block_topk", value_bits=8, max_gamma=0.1),
     0.04),
    (dict(gamma=0.01, method="topk", value_bits=16, max_gamma=0.1), 0.03),
]


def _case_id(case):
    kw, g = case
    return "-".join(str(v) for v in kw.values()) + f"-dl{g}"


@functools.lru_cache(maxsize=None)
def _japply(comp_items):
    comp = JCompressor(**dict(comp_items))
    return jax.jit(lambda ups, mem, gamma: jdl.apply_downlink(
        ups, STACKED, comp, jdl.DownlinkState(mem, gamma)))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_apply_downlink_matches_jax(case):
    """Two server rounds, the second from the carried memory: decoded
    updates, server memory and both byte counts bit for bit."""
    kw, gamma = case
    comp = Compressor(**kw)
    japply = _japply(tuple(kw.items()))
    size = dl.server_memory_size(dl.downlink_plan(SHAPES, STACKED, comp))
    jmem = jnp.zeros((size,), jnp.float32)
    state = dl.init_downlink_state(SHAPES, STACKED, comp, gamma)
    assert tuple(state.memory.shape) == (size,) and state.gamma == f32(gamma)
    for seed in (1, 2):
        ups = _updates(seed)
        jups, jstate, jwire_b, jeff = japply(
            [jnp.asarray(u) for u in ups], jmem, jnp.float32(gamma))
        tups, state, wire_b, eff = dl.apply_downlink(
            [torch.from_numpy(u.copy()) for u in ups], STACKED, comp, state)
        for i, (a, b) in enumerate(zip(jups, tups)):
            np.testing.assert_array_equal(
                np.asarray(a).view(np.int32), b.numpy().view(np.int32),
                err_msg=f"leaf {i}, round {seed}")
        np.testing.assert_array_equal(np.asarray(jstate.memory),
                                      state.memory.numpy())
        assert (float(wire_b), float(eff)) == (float(jwire_b), float(jeff))
        assert isinstance(wire_b, np.float32) and state.gamma == f32(gamma)
        for i in (2, 3):        # dense leaves return exactly
            np.testing.assert_array_equal(tups[i].numpy(), ups[i])
        jmem = jstate.memory
    assert np.abs(state.memory.numpy()).max() > 0


def _rows(kw, d, R=3, seed=0):
    comp = Compressor(**kw)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (R, d)).astype(f32))
    vals, idx, _ = compress_leaf(x, comp, True)
    return comp, wire.WireSpec.for_row(comp, d), vals, idx


#: the downlink's rows: 32- and 8-bit block-local, ragged at count 41 of
#: 102, ragged with a count per row, flat rows at 4 and 16 bits
ROUNDTRIP = [
    (dict(gamma=0.01, method="block_topk"), 5000, None),
    (dict(gamma=0.01, method="block_topk", value_bits=8), 5000, None),
    (dict(gamma=0.04, method="block_topk", value_bits=8, max_gamma=0.1),
     5000, [41, 41, 41]),
    (dict(gamma=0.04, method="block_topk", max_gamma=0.1), 5000,
     [1, 102, 57]),
    (dict(gamma=0.02, method="topk", value_bits=4), 3000, None),
    (dict(gamma=0.02, method="topk", value_bits=16, max_gamma=0.05), 3000,
     [60, 3, 150]),
]


@pytest.mark.parametrize("kw,d,counts", ROUNDTRIP,
                         ids=[f"{i}" for i in range(len(ROUNDTRIP))])
def test_roundtrip_rows_matches_jax_and_the_wire(kw, d, counts):
    """``roundtrip_rows`` equals the port's ``decode_rows(encode_rows)``
    through the codec and JAX's ``roundtrip_rows``, bit for bit."""
    comp, spec, vals, idx = _rows(kw, d)
    c = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    rv, ri = wire.roundtrip_rows(vals, idx, spec, counts=c)
    wv, wi = wire.decode_rows(wire.encode_rows(vals, idx, spec, counts=c),
                              spec)
    jspec = jwire.WireSpec(**dataclasses.asdict(spec))
    jv, ji = jax.jit(lambda v, i, cc: jwire.roundtrip_rows(
        v, i, jspec, counts=cc))(
            jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()),
            None if c is None else jnp.asarray(c.numpy()))
    for got, want in ((rv, wv), (rv.numpy(), np.asarray(jv))):
        got = got.numpy() if torch.is_tensor(got) else got
        want = want.numpy() if torch.is_tensor(want) else want
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    np.testing.assert_array_equal(ri.numpy(), wi.numpy())
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ji))
    if counts is not None:
        assert (rv == 0).any()


def _lm_geometry():
    params = lm.init_params(get_smoke_config(ref.ARCH), seed=0)
    return ([tuple(p.shape) for p in tree_flatten(params)[0]],
            tree_flatten(lm.stacked_mask(params))[0])


@pytest.mark.parametrize("kw", [
    dict(gamma=0.01, method="block_topk"),
    dict(gamma=0.05, method="topk", value_bits=8),
    dict(gamma=0.04, method="block_topk", value_bits=8, max_gamma=0.1),
    dict(gamma=0.01, method="none")], ids=lambda kw: "-".join(
        str(v) for v in kw.values()))
def test_plan_and_byte_helpers_match_jax(kw):
    comp, jcomp = Compressor(**kw), JCompressor(**kw)
    for shapes, stacked in ((SHAPES, STACKED), _lm_geometry()):
        plan = dl.downlink_plan(shapes, stacked, comp)
        jplan = jdl.downlink_plan(shapes, stacked, jcomp)
        assert [(ln.index, ln.L, ln.d, ln.dense, ln.word_off,
                 None if ln.spec is None else dataclasses.asdict(ln.spec))
                for ln in plan.leaves] == \
            [(ln.index, ln.L, ln.d, ln.dense, ln.word_off,
              None if ln.spec is None else dataclasses.asdict(ln.spec))
             for ln in jplan.leaves]
        assert dl.server_memory_size(plan) == jdl.server_memory_size(jplan)
        assert dl.downlink_wire_bytes(plan) == jdl.downlink_wire_bytes(jplan)
        assert dl.dense_downlink_bytes(shapes) == \
            jdl.dense_downlink_bytes(shapes)
        st = dl.init_downlink_state(shapes, stacked, comp, 0.02)
        jst = jdl.init_downlink_state(shapes, stacked, jcomp, 0.02)
        assert tuple(st.memory.shape) == jst.memory.shape
        assert st.memory.dtype == torch.float32 and not st.memory.any()
        assert st.gamma == np.asarray(jst.gamma)
    assert dl.MODES == jdl.MODES


#: csgd_asss at gamma 0.01, and acgd on perleaf inside a 10% budget with
#: the downlink's own linear ramp.  At 32-bit values: at 8
#: bits an ulp of the uplink's accumulator (XLA and PyTorch sum the
#: backward pass in other orders) can round a quantized field to the
#: next step, which moves one entry of the parameters and of the EF
#: memory by one quantization step (seen: acgd on perleaf at 8 bits, one
#: entry of blocks/mlp/wo at step 1, 9.58e-5 against a tolerance of
#: 2.7e-6, in the parameters and the uplink's EF memory alike; ROADMAP
#: queue 3).  The 8-bit downlink itself is held bit for bit by
#: test_apply_downlink_matches_jax.
TRAINER = [ref.Case("csgd_asss", downlink="compressed"),
           ref.Case("acgd", transport="perleaf", max_gamma=0.1, gamma=0.04,
                    downlink="compressed", downlink_gamma=0.02,
                    downlink_schedule="linear")]


@pytest.mark.parametrize("case", TRAINER, ids=ref.case_id)
def test_trainer_downlink_matches_jax(case):
    _, state, log = ref.run_both(case)
    assert all(m["downlink_wire_bytes"] > 0 for m in log)
    if case.max_gamma:
        # the ramp: 0.02 -> 0.06 -> 0.1 prices more each round
        eff = [m["downlink_effective_wire_bytes"] for m in log]
        assert eff[0] < eff[1] < eff[2] == log[0]["downlink_wire_bytes"]
    else:
        assert all(m["downlink_effective_wire_bytes"]
                   == m["downlink_wire_bytes"] == m["wire_bytes"]
                   for m in log)


def _exchange_inputs(seed=3):
    rng = np.random.default_rng(seed)
    grads = {f"l{i}": rng.standard_normal(s).astype(f32)
             for i, s in enumerate(SHAPES)}
    mem = {k: (0.05 * rng.standard_normal(v.shape)).astype(f32)
           for k, v in grads.items()}
    return grads, mem


def _server(comp, gamma, memory=None):
    state = dl.init_downlink_state(SHAPES, STACKED, comp, gamma)
    if memory is not None:
        state = dl.DownlinkState(memory, state.gamma)
    return dl.DownlinkCtx(state)


@pytest.mark.parametrize("transport", ["bucketed", "perleaf"])
def test_uplink_unchanged_by_the_downlink(transport):
    """The uplink's EF memory, bytes and telemetry are bit-identical with
    the downlink on; only the compressed leaves' updates change, and the
    exchange returns one more element."""
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    grads, mem = _exchange_inputs()
    smask = {f"l{i}": s for i, s in enumerate(STACKED)}
    args = (to_torch(grads), to_torch(mem), f32(0.3), comp)
    kw = dict(stacked_mask=smask, gamma_t=f32(0.07), transport=transport)
    plain = worker_compress_aggregate(*args, **kw)
    down = worker_compress_aggregate(*args, downlink_ctx=_server(comp, 0.04),
                                     **kw)
    assert len(plain) == 5 and len(down) == 6
    for k in mem:
        np.testing.assert_array_equal(plain[1][k].numpy(),
                                      down[1][k].numpy())
    assert plain[2:4] == down[2:4]
    for a, b in zip(dataclasses.astuple(plain[4]),
                    dataclasses.astuple(down[4])):
        assert torch.equal(a, b)
    for i, k in enumerate(sorted(mem)):
        same = torch.equal(plain[0][k], down[0][k])
        assert same == (i in (2, 3)), k
    res = down[5]
    assert res.wire_bytes == plain[2] and res.eff_wire_bytes < plain[2]


def test_server_ef_recycles():
    """Round 2 from the carried server memory differs from round 2 from a
    zeroed one: what the downlink dropped in round 1 is sent later."""
    comp = Compressor(gamma=0.02, method="block_topk")
    ups1, ups2 = _updates(5), _updates(6)
    t = lambda u: [torch.from_numpy(x.copy()) for x in u]  # noqa: E731
    _, carried, _, _ = dl.apply_downlink(
        t(ups1), STACKED, comp, _server(comp, 0.02).state)
    assert carried.memory.abs().max() > 0
    fresh = _server(comp, 0.02).state
    a, _, _, _ = dl.apply_downlink(t(ups2), STACKED, comp, carried)
    b, _, _, _ = dl.apply_downlink(t(ups2), STACKED, comp, fresh)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[4], b[4])
    assert torch.equal(a[2], b[2])          # dense leaves: no server memory


SMOKE_SHAPE = dict(model=get_smoke_config(ref.ARCH),
                   shape=ShapeConfig(ref.SEQ, ref.BATCH))


def _jax_error(kw, micro=1):
    """JAX's message for ``kw``: from its OptimizerConfig, else from its
    build_train_step on a 1-device mesh."""
    kw = dict(kw)
    for name in ("downlink_gamma", "gamma_controller"):
        if name in kw:
            kw[name] = JGammaCfg(**kw[name])
    with pytest.raises(ValueError) as e:
        jrun = JRunConfig(
            model=ref.jax_smoke_config(ref.ARCH),
            shape=JShapeConfig("cli", ref.SEQ, ref.BATCH, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(**kw))
        jbuild_train_step(None, jrun, jax.make_mesh((1,), ("data",)))
    return str(e.value)


def _port_error(kw, micro=1):
    kw = dict(kw)
    for name in ("downlink_gamma", "gamma_controller"):
        if name in kw:
            kw[name] = GammaControllerConfig(**kw[name])
    with pytest.raises(ValueError) as e:
        RunConfig(microbatches=micro, optimizer=OptimizerConfig(**kw),
                  **SMOKE_SHAPE)
    return str(e.value)


@pytest.mark.parametrize("kw,micro", [
    (dict(downlink="both"), 1),
    (dict(downlink="compressed",
          downlink_gamma=dict(schedule="ef-coupled")), 1),
    (dict(downlink="compressed",
          downlink_gamma=dict(schedule="armijo-coupled")), 1),
    (dict(downlink="compressed", kind="sls"), 1),
    (dict(downlink="compressed", kind="dense"), 1),
    (dict(downlink="compressed", kind="sgd"), 1),
    (dict(downlink="compressed", shard_local_topk=True), 1),
    (dict(downlink="compressed", local_steps=2), 2),
    (dict(downlink="compressed", kind="acgd", local_steps=2), 2)],
    ids=lambda x: str(x) if isinstance(x, int) else "-".join(
        f"{v}" for v in x.values() if not isinstance(v, dict)))
def test_errors_match_jax_word_for_word(kw, micro):
    assert _port_error(kw, micro) == _jax_error(kw, micro)


def test_memory_size_and_stateful_transport_errors_match_jax():
    comp, jcomp = Compressor(), JCompressor()
    ups = _updates(1)
    with pytest.raises(ValueError) as e:
        jdl.apply_downlink([jnp.asarray(u) for u in ups], STACKED, jcomp,
                           jdl.DownlinkState(jnp.zeros((7,)),
                                             jnp.float32(0.01)))
    with pytest.raises(ValueError) as t:
        dl.apply_downlink([torch.from_numpy(u) for u in ups], STACKED, comp,
                          dl.DownlinkState(torch.zeros(7), f32(0.01)))
    assert str(t.value) == str(e.value)
    # a stateful transport refuses the downlink (JAX checks it before
    # touching its inputs), and a missing context before that
    for kw in (dict(transport="gossip", transport_ctx=object()),
               dict(transport="overlap", transport_ctx=object()),
               dict(transport="overlap")):
        with pytest.raises(ValueError) as e:
            jwca(None, None, None, jcomp, ("data",), downlink_ctx=object(),
                 **kw)
        with pytest.raises(ValueError) as t:
            worker_compress_aggregate(None, None, None, comp,
                                      downlink_ctx=object(), **kw)
        assert str(t.value) == str(e.value), kw
    assert "needs transport_ctx" in str(t.value)
    assert ttransport.get_transport("gossip").stateful


def _dl_worker_round(rank, W):
    """Two downlink rounds of worker ``rank`` on its own grads; returns
    the decoded updates and the server memory of each round."""
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    smask = {f"l{i}": s for i, s in enumerate(STACKED)}
    ctx = _server(comp, 0.04)
    mem = None
    out = []
    for r in range(2):
        grads, m0 = _exchange_inputs(20 + 2 * rank + r)
        upd, mem, _, _, _, res = worker_compress_aggregate(
            to_torch(grads), mem if mem is not None else to_torch(m0),
            f32(0.3), comp, stacked_mask=smask,
            gamma_t=f32((0.02, 0.07)[rank % 2]), downlink_ctx=ctx)
        ctx = dl.DownlinkCtx(res.state)
        out.append((to_numpy(upd), res.state.memory.numpy().copy()))
    return out


def _dl_worker(rank, port, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        queue.put((rank, _dl_worker_round(rank, 2)))
    finally:
        dist.destroy_process_group()


def test_two_workers_hold_identical_server_state():
    """Two gloo workers at different gamma_t and with different grads:
    the decoded updates and the server memory are bit-identical across
    ranks in both rounds — every rank simulates one server from the same
    gathered mean, with no collective of its own."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_dl_worker, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    for (u0, m0), (u1, m1) in zip(got[0], got[1]):
        np.testing.assert_array_equal(m0.view(np.int32), m1.view(np.int32))
        assert np.abs(m0).max() > 0
        for k in u0:
            np.testing.assert_array_equal(u0[k], u1[k], err_msg=k)
    assert not np.array_equal(got[0][0][1], got[0][1][1])


SMOKE = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
         "4", "--compress-method", "block_topk", "--log-every", "1",
         "--opt", "acgd", "--downlink", "compressed"]


def test_resume_equals_uninterrupted(tmp_path, capsys):
    """Under ``--opt acgd --downlink compressed``: 4 steps straight
    against 2, then ``--resume`` to 4 — every logged metric and the final
    checkpoint (velocity and server state included) bit-identical."""
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    log = train_cli.main(SMOKE + ["--steps", "4", "--ckpt-dir", straight])
    first = train_cli.main(SMOKE + ["--steps", "2", "--ckpt-dir", split,
                                    "--ckpt-every", "1"])
    capsys.readouterr()
    second, _, state = train_cli.run(SMOKE + ["--steps", "4", "--ckpt-dir",
                                              split, "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    strip = lambda lg: [{k: v for k, v in m.items() if k != "step_s"}  # noqa
                        for m in lg]
    assert strip(first + second) == strip(log)
    assert all("downlink_effective_wire_bytes" in m for m in log)
    assert log[-1]["cum_effective_wire_bytes"] == 4 * (
        log[0]["effective_wire_bytes"]
        + log[0]["downlink_effective_wire_bytes"])

    def final(d):
        d = os.path.join(d, "rank_000")
        p = os.path.join(d, f"step_{tckpt.latest_step(d):010d}")
        z = np.load(os.path.join(p, "arrays.npz"))
        with open(os.path.join(p, "manifest.json")) as f:
            return json.load(f), {k: z[k] for k in z.files}

    (ms, zs), (mr, zr) = final(straight), final(split)
    assert ms == mr
    paths = set(ms["paths"])
    assert {"state/downlink/memory", "state/downlink/gamma"} <= paths
    assert sum(p.startswith("state/velocity/") for p in paths) == len(
        tree_flatten(state.velocity)[0])
    for k in zs:
        np.testing.assert_array_equal(np.atleast_1d(zs[k]).view(np.uint8),
                                      np.atleast_1d(zr[k]).view(np.uint8),
                                      err_msg=k)
