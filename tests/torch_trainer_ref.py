"""A JAX reference round of the trainer for ``kind="acgd"``, the
compressed downlink and the overlap and gossip transports, shared by
tests/test_torch_acgd.py, tests/test_torch_downlink.py,
tests/test_torch_overlap_train.py and tests/test_torch_gossip_train.py.

The reference composes ``worker_fn``'s lines
(src/repro/launch/train_step.py:685-941) from the JAX package's own
functions — ``armijo_search``, ``gamma_update``, the acgd round's two
momentum lines as the worker writes them, the downlink's gamma round and
``worker_compress_aggregate(downlink_ctx=...)`` or its overlap seam
(``transport_ctx=OverlapCtx``, :742-790, and the ``staleness`` metric)
or its gossip seam (``transport_ctx=GossipCtx``, :763-772, and the
breaker's gossip rule, :858-866),
``all_finite`` and ``advance_health`` — jitted, with the model OUTSIDE
any mesh (the LM step under a mesh fails on this tree, ROADMAP queue
3); only the exchange runs in a 1-device ``shard_map``, for its
collectives.  With ``local_steps`` H > 1 the round is
``_local_steps_worker``'s (:381-509): H searched local steps in a
``lax.scan``, then one exchange of the model delta at eta 1.

:func:`run_both` drives the port's ``train_step`` beside it, each round
from the reference's parameters, EF memory, velocity and server memory
(free running, an ulp of one round can split a near-tie at a block's
threshold in the next and move a whole entry — ROADMAP queue 3), with
the port's own carried host scalars.  Tolerances as in
tests/test_torch_kinds.py: loss and alpha rel 1e-5; parameters, EF
memory, velocity and each leaf's rows of the server memory within 1e-5
of the parameter leaf's max |p|; gamma_t of both controllers bit for
bit; n_evals, the byte counts, ``cum_effective_wire_bytes`` and the
health counters exact.

:func:`run_gossip_workers` is the gossip round on W workers: each
worker's gradients, search and eta computed with the model outside any
mesh as above, the exchange alone vmapped over W (``axis_name="data"``,
whose ``ppermute`` batching rule equals a W-device mesh), and the port
on W gloo workers (tests/torch_gossip_workers.py) from the reference's
per-worker parameters and EF memory each round.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from repro.comm.downlink import DownlinkCtx as JDownlinkCtx
from repro.comm.downlink import DownlinkState as JDownlinkState
from repro.comm.downlink import init_downlink_state as jinit_downlink
from repro.comm.gossip import GossipConfig as JGossipConfig
from repro.comm.gossip import GossipCtx as JGossipCtx
from repro.comm.gossip import GossipState as JGossipState
from repro.comm.overlap import OverlapConfig as JOverlapConfig
from repro.comm.overlap import OverlapCtx as JOverlapCtx
from repro.comm.overlap import init_overlap_state as jinit_overlap
from repro.comm.topology import build_topology as jbuild_topology
from repro.compat import shard_map
from repro.configs import get_smoke_config as jax_smoke_config
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
from repro.models import build_model
from repro_torch.comm.bucket import decode_buckets
from repro_torch.comm.downlink import DownlinkState, downlink_plan
from repro_torch.comm.gossip import GossipConfig, GossipState
from repro_torch.comm.overlap import OverlapConfig, OverlapState
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig
from repro_torch.core.leafmath import scatter_layers
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import lm
from repro_torch.utils import tree_flatten

ARCH = "paper-lm-100m"
SEQ, BATCH, GAMMA, STEPS = 33, 6, 0.01, 3
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class Case:
    """One trainer configuration, in the terms both packages share."""

    kind: str
    transport: str = "bucketed"
    schedule: str = "fixed"
    max_gamma: float = 0.0
    value_bits: int = 32
    gamma: float = GAMMA
    downlink: str = "dense"
    downlink_gamma: float = 0.0
    downlink_schedule: str = "fixed"
    eta: float = 0.1
    momentum: float = 0.9
    max_skips: int = 25
    overlap_delay: int = 1        # read under transport="overlap"
    overlap_chunks: int = 3
    local_steps: int = 1
    topology: str = "ring"        # read under transport="gossip"
    arch: str = ARCH              # the smoke variant of this config
    micro: int = 1                # microbatches of a one-step round
    remat: bool = False           # the smoke variants' value: JAX's

    def comp_kw(self):
        return dict(gamma=self.gamma, method="block_topk",
                    value_bits=self.value_bits, max_gamma=self.max_gamma)

    def ctrl_kw(self):
        return dict(schedule=self.schedule, ramp_steps=2)

    def dl_ctrl_kw(self):
        return dict(schedule=self.downlink_schedule,
                    gamma0=self.downlink_gamma, ramp_steps=2)

    def overlap(self):
        return dict(n_chunks=self.overlap_chunks, delay=self.overlap_delay)

    def run(self) -> RunConfig:
        return RunConfig(
            model=dataclasses.replace(get_smoke_config(self.arch),
                                      remat=self.remat),
            shape=ShapeConfig(SEQ, BATCH),
            microbatches=max(self.local_steps, self.micro),
            optimizer=OptimizerConfig(
                overlap=OverlapConfig(**self.overlap()),
                gossip=GossipConfig(topology=self.topology),
                local_steps=self.local_steps,
                kind=self.kind, eta=self.eta, momentum=self.momentum,
                max_consecutive_skips=self.max_skips,
                compressor=Compressor(**self.comp_kw()),
                gamma_controller=GammaControllerConfig(**self.ctrl_kw()),
                transport=self.transport, downlink=self.downlink,
                downlink_gamma=GammaControllerConfig(**self.dl_ctrl_kw())))


def case_id(case: Case) -> str:
    return "-".join(f"{v}" for k, v in dataclasses.asdict(case).items()
                    if v != getattr(Case, k, None) or k == "kind")


@functools.lru_cache(maxsize=None)
def jax_model(arch: str = ARCH, remat: bool = False):
    """JAX's smoke model of ``arch`` (``remat`` replaced) and its initial
    weights; a vlm's gates, 0 at init (which keeps its cross blocks out
    of the forward and their gradient), drawn in [0.5, 1) from seed 11."""
    model = build_model(dataclasses.replace(jax_smoke_config(arch),
                                            remat=remat))
    params = model.init(jax.random.PRNGKey(0))
    if "cross" in params:
        rng = np.random.default_rng(11)
        params["cross"] = {**params["cross"], **{
            k: jnp.asarray(rng.uniform(0.5, 1.0, params["cross"][k].shape),
                           jnp.float32) for k in ("gate_attn", "gate_mlp")}}
    return model, params


@functools.lru_cache(maxsize=None)
def jax_step(case: Case):
    """One worker's round of ``worker_fn`` for ``case``, jitted.
    ``ctx``: (alpha_prev, n_evals_ema, gamma_prev, step, telemetry,
    health, downlink gamma, cum_eff); ``dl_mem`` the server memory (a
    0-word placeholder without the downlink); ``ov`` the carried
    ``OverlapState`` (``()`` without the overlap transport), returned
    last."""
    model, _ = jax_model(case.arch, case.remat)
    comp = JCompressor(**case.comp_kw())
    arm = JArmijo()
    ctrl = JGammaCfg(**case.ctrl_kw())
    dl_ctrl = JGammaCfg(**case.dl_ctrl_kw())
    mesh = jax.make_mesh((1,), ("data",))
    mu = case.momentum
    acgd_mode = case.kind == "acgd"
    downlink_mode = case.downlink == "compressed"
    overlap_mode = case.transport == "overlap"
    gossip_mode = case.transport == "gossip"
    ov_cfg = JOverlapConfig(**case.overlap())
    H = case.local_steps

    def local_loss(params, batch):
        return model.loss(params, batch)[0]

    def exchange(send, mem, eta, gamma_t, ov, smask):
        """The plain exchange, or the overlap seam (worker_fn:775-785,
        _local_steps_worker:422-435) or the gossip seam at one worker
        (worker_fn:763-772), whose carried state rides in ``ov``:
        ``(..., new ov or ())``."""
        spec = jax.tree.map(lambda _: P(), send)
        if gossip_mode:
            ctx = lambda st: JGossipCtx(  # noqa: E731
                jbuild_topology(case.topology, 1),
                JGossipConfig(topology=case.topology), st)
            return shard_map(
                lambda g, m, e, gt, st: jwca(
                    g, m, e, comp, ("data",), stacked_mask=smask,
                    gamma_t=gt, transport="gossip", transport_ctx=ctx(st)),
                mesh=mesh, in_specs=(spec, spec, P(), P(), P()),
                out_specs=(spec, spec, P(), P(), P(), P()),
                axis_names={"data"})(send, mem, eta, gamma_t, ov)
        if not overlap_mode:
            return shard_map(
                lambda g, m, e, gt: jwca(
                    g, m, e, comp, ("data",), stacked_mask=smask,
                    gamma_t=gt, transport=case.transport),
                mesh=mesh, in_specs=(spec, spec, P(), P()),
                out_specs=(spec, spec, P(), P(), P()),
                axis_names={"data"})(send, mem, eta, gamma_t) + ((),)
        return shard_map(
            lambda g, m, e, gt, st: jwca(
                g, m, e, comp, ("data",), stacked_mask=smask, gamma_t=gt,
                transport="overlap",
                transport_ctx=JOverlapCtx(cfg=ov_cfg, state=st)),
            mesh=mesh, in_specs=(spec, spec, P(), P(), P()),
            out_specs=(spec, spec, P(), P(), P(), P()),
            axis_names={"data"})(send, mem, eta, gamma_t, ov)

    def finish(params, mem, vel, dl_mem, ov, ctx, upd, new_mem, new_vel,
               new_dl_mem, new_ov, metrics, loss, new_alpha, new_ema,
               gamma_t, tel, dl_gamma, eff, dl_eff):
        """worker_fn:836-941: cum_eff, the parameters, the breaker."""
        (alpha_prev, ema, gamma_prev, t, tel_prev, health, dl_gamma_prev,
         cum_eff) = ctx
        new_cum = cum_eff + eff
        if downlink_mode:
            new_cum = new_cum + dl_eff
        if overlap_mode:
            metrics["stale"] = jnp.float32(case.overlap_delay) * ov.seeded
        new_params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) - u).astype(p.dtype),
            params, upd)
        step_ok = jnp.isfinite(loss)
        if not gossip_mode:
            step_ok &= jall_finite(upd)
        new_params = jax.tree.map(
            lambda a, b: jnp.where(step_ok, a, b), new_params, params)
        new_health = jadvance_health(health, step_ok, t, jnp.float32(0.0))
        new_ctx = (new_alpha, new_ema, gamma_t, t + 1, tel, new_health,
                   dl_gamma, new_cum)
        frozen = (alpha_prev, ema, gamma_prev, t + 1, tel_prev, new_health,
                  dl_gamma_prev, new_cum)
        new_ctx, new_mem, new_vel, new_dl_mem, new_ov = jax.tree.map(
            lambda a, b: jnp.where(step_ok, a, b),
            (new_ctx, new_mem, new_vel, new_dl_mem, new_ov),
            (frozen, mem, vel, dl_mem, ov))
        return (new_params, new_mem, new_vel, new_dl_mem, new_ctx, metrics,
                step_ok, new_ov)

    def local_round(params, mem, vel, dl_mem, ctx, batch, ov):
        """_local_steps_worker:386-449, written as the worker writes it."""
        alpha_prev, ema, gamma_prev, t, tel_prev = ctx[:5]
        mbs = jax.tree.map(
            lambda x: x.reshape(H, x.shape[0] // H, *x.shape[1:]), batch)

        def one(carry, mb):
            p_loc, amax, ev = carry
            loss, g = jax.value_and_grad(local_loss)(p_loc, mb)
            res = jarmijo(lambda p: local_loss(p, mb), p_loc, g, amax, arm,
                          f0=loss, grad_sqnorm=jsqnorm(g))
            eta = arm.a_scale * res.alpha
            p_loc = jax.tree.map(
                lambda p, gg: (p.astype(jnp.float32)
                               - eta * gg.astype(jnp.float32)).astype(p.dtype),
                p_loc, g)
            return (p_loc, jnext_alpha_max(res.alpha, arm),
                    ev + res.n_evals.astype(jnp.float32)), (loss, res.alpha)

        (p_end, amax_f, evals), (losses, alphas) = jax.lax.scan(
            one, (params, jnext_alpha_max(alpha_prev, arm),
                  jnp.float32(0.0)), mbs)
        gamma_t = jgamma_update(
            ctrl, comp, gamma_prev, t,
            search=JSearch(alpha=alphas[-1], alpha_prev=alpha_prev,
                           n_evals=evals / H, n_evals_ema=ema),
            compression=tel_prev)
        delta = jax.tree.map(
            lambda a, b: a.astype(jnp.float32) - b.astype(jnp.float32),
            params, p_end)
        upd, new_mem, wire, eff, tel, new_ov = exchange(
            delta, mem, jnp.float32(1.0), gamma_t, ov,
            model.stacked_mask(params))
        loss = jnp.mean(losses)
        metrics = dict(loss=loss, alpha=alphas[-1], n_evals=evals / H,
                       wire=wire, eff=eff, dl_wire=None, dl_eff=None)
        return finish(params, mem, vel, dl_mem, ov, ctx, upd, new_mem, vel,
                      dl_mem, new_ov, metrics, loss, amax_f / arm.omega,
                      0.9 * ema + 0.1 * evals / H, gamma_t, tel, ctx[6],
                      eff, None)

    @jax.jit
    def step(params, mem, vel, dl_mem, ctx, batch, ov=()):
        if H > 1:
            return local_round(params, mem, vel, dl_mem, ctx, batch, ov)
        (alpha_prev, ema, gamma_prev, t, tel_prev, health, dl_gamma_prev,
         cum_eff) = ctx
        # worker_fn:664-682: the microbatch sum, every key of the batch
        # split, and the search on the first microbatch
        if case.micro > 1:
            M = case.micro
            mbs = jax.tree.map(
                lambda x: x.reshape(M, x.shape[0] // M, *x.shape[1:]), batch)
            probe = jax.tree.map(lambda x: x[0], mbs)

            def acc(carry, mb):
                lo, g = jax.value_and_grad(local_loss)(params, mb)
                cl, cg = carry
                return (cl + lo, jax.tree.map(jnp.add, cg, g)), None

            zero_g = jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (loss_sum, grads), _ = jax.lax.scan(
                acc, (jnp.float32(0.0), zero_g), mbs)
            loss = loss_sum / M
            grads = jax.tree.map(lambda g: g / M, grads)
        else:
            probe = batch
            loss, grads = jax.value_and_grad(local_loss)(params, batch)
        gsq = jsqnorm(grads)
        # worker_fn:685-719
        if case.kind == "csgd_asss":
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
        # worker_fn:725-741
        if acgd_mode:
            new_vel = jax.tree.map(
                lambda v, g: mu * v + g.astype(jnp.float32), vel, grads)
            send = jax.tree.map(
                lambda v, g: mu * v + g.astype(jnp.float32), new_vel, grads)
        else:
            new_vel, send = vel, grads
        spec = jax.tree.map(lambda _: P(), params)
        smask = model.stacked_mask(params)
        # worker_fn:786-800
        dl_gamma = dl_gamma_prev
        new_ov = ov
        if downlink_mode:
            dl_gamma = jgamma_update(dl_ctrl, comp, dl_gamma_prev, t)
            upd, new_mem, wire, eff, tel, dl_res = shard_map(
                lambda g, m, e, gt, dm, dg: jwca(
                    g, m, e, comp, ("data",), stacked_mask=smask,
                    gamma_t=gt, transport=case.transport,
                    downlink_ctx=JDownlinkCtx(JDownlinkState(dm, dg))),
                mesh=mesh, in_specs=(spec, spec, P(), P(), P(), P()),
                out_specs=(spec, spec, P(), P(), P(), P()),
                axis_names={"data"})(send, mem, eta, gamma_t, dl_mem,
                                     dl_gamma)
            new_dl_mem = dl_res.state.memory
            dl_wire, dl_eff = dl_res.wire_bytes, dl_res.eff_wire_bytes
        else:
            upd, new_mem, wire, eff, tel, new_ov = exchange(
                send, mem, eta, gamma_t, ov, smask)
            new_dl_mem, dl_wire, dl_eff = dl_mem, None, None
        metrics = dict(loss=loss, alpha=alpha_m, n_evals=evals_m, wire=wire,
                       eff=eff, dl_wire=dl_wire, dl_eff=dl_eff)
        return finish(params, mem, vel, dl_mem, ov, ctx, upd, new_mem,
                      new_vel, new_dl_mem, new_ov, metrics, loss, new_alpha,
                      new_ema, gamma_t, tel, dl_gamma, eff, dl_eff)

    return step


def assert_tree_close(jtree, ttree, ptree, what):
    """|jax - torch| <= 1e-5 * max|p| per leaf, p the parameter leaf."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            assert_tree_close(v, ttree[k], ptree[k], f"{what}/{k}")
            continue
        a, b = np.asarray(v), ttree[k].detach().numpy()
        scale = float(np.abs(np.asarray(ptree[k])).max())
        assert np.abs(a - b).max() <= 1e-5 * scale, \
            f"{what}/{k}: {np.abs(a - b).max()} vs max|p| {scale}"


def assert_server_close(jmem, tmem, params, comp):
    """Each compressed leaf's rows of the flat server memory within 1e-5
    of that parameter leaf's max |p|."""
    leaves = tree_flatten(params)[0]
    plan = downlink_plan([p.shape for p in leaves],
                         tree_flatten(lm.stacked_mask(params))[0], comp)
    a, b = np.asarray(jmem), tmem.numpy()
    assert a.shape == b.shape
    off = 0
    for ln in plan.leaves:
        if ln.dense:
            continue
        n = ln.L * ln.d
        scale = float(np.abs(leaves[ln.index].numpy()).max())
        err = np.abs(a[off:off + n] - b[off:off + n]).max()
        assert err <= 1e-5 * scale, f"server memory of leaf {ln.index}: " \
            f"{err} vs max|p| {scale}"
        off += n
    assert off == a.size


def _plan_of(params, comp):
    leaves = tree_flatten(params)[0]
    return leaves, downlink_plan([p.shape for p in leaves],
                                 tree_flatten(lm.stacked_mask(params))[0],
                                 comp)


def to_port_overlap(jst) -> OverlapState:
    """The port's twin of JAX's carried ``OverlapState`` (uint32 words
    read as int32: the same bits)."""
    return OverlapState(
        payload=torch.from_numpy(np.asarray(jst.payload).view(np.int32)
                                 .copy()),
        dense=torch.from_numpy(np.array(jst.dense)),
        eff_wire=f32(np.asarray(jst.eff_wire)),
        seeded=f32(np.asarray(jst.seeded)))


def assert_overlap_close(jst, tst, params, comp):
    """The carried state: effective bytes and ``seeded`` bit for bit; each
    compressed leaf's decoded payload rows and each dense leaf's carried
    accumulator within 1e-5 of that parameter leaf's max |p| (both sides
    encode their own gradients, which differ in the last bits)."""
    leaves, plan = _plan_of(params, comp)
    assert f32(tst.eff_wire).view(np.int32) == \
        np.asarray(jst.eff_wire, np.float32).view(np.int32)
    assert tst.seeded == float(np.asarray(jst.seeded))
    dec = [decode_buckets(plan, pay[None]) for pay in (
        to_port_overlap(jst).payload, tst.payload)]
    off = 0
    for ln in plan.leaves:
        scale = float(leaves[ln.index].abs().max())
        if ln.dense:
            n = ln.L * ln.d
            a = np.asarray(jst.dense)[off:off + n]
            b = tst.dense.numpy()[off:off + n]
            off += n
        else:
            a, b = (scatter_layers(*d[ln.index], ln.L, ln.d).numpy()
                    for d in dec)
        err = float(np.abs(a - b).max())
        assert err <= 1e-5 * scale, f"carried leaf {ln.index}: {err} " \
            f"vs max|p| {scale}"
    assert off == tst.dense.numel()


def assert_gossip_state(jst, tst: GossipState, maxulp=0):
    """The carried (v, lr): 0-dim f32 tensors, equal to JAX's within
    ``maxulp``."""
    for f in ("v", "lr"):
        t = getattr(tst, f)
        assert t.dtype == torch.float32 and t.dim() == 0
        np.testing.assert_array_max_ulp(
            np.float32(np.asarray(getattr(jst, f))),
            np.float32(t.cpu().numpy()), maxulp=maxulp)


def _copy(tree):
    """Fresh device arrays: a jitted round fed its own outputs would
    compile again (their shardings differ)."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


def run_both(case: Case, steps: int = STEPS):
    """``steps`` rounds of ``case`` through both packages from JAX's
    initial weights, checked round by round.  Returns the port's last
    parameters, its state and its metrics."""
    model, params = jax_model(case.arch)
    comp = JCompressor(**case.comp_kw())
    jstep = jax_step(case)
    mem = jax.tree.map(jnp.zeros_like, params)
    vel = jax.tree.map(jnp.zeros_like, params)
    if case.downlink == "compressed":
        flat, _ = jax.tree.flatten(params)
        dl0 = jinit_downlink(
            [x.shape for x in flat],
            jax.tree.flatten(model.stacked_mask(params))[0], comp,
            JGammaCfg(**case.dl_ctrl_kw()).resolve(comp)[0])
        dl_mem, dl_gamma = dl0.memory, dl0.gamma
    else:
        dl_mem, dl_gamma = jnp.zeros((0,), jnp.float32), jnp.float32(0.0)
    ov = ()
    if case.transport == "overlap":
        ov = jinit_overlap(
            [x.shape for x in jax.tree.leaves(params)],
            jax.tree.leaves(model.stacked_mask(params)), comp)
    if case.transport == "gossip":
        ov = JGossipState.init()
    ctx = (jnp.float32(JArmijo().alpha0), jnp.float32(0.0),
           jgamma_init(JGammaCfg(**case.ctrl_kw()), comp), jnp.int32(0),
           JTel.init(), JHealth.init(), dl_gamma, jnp.float32(0.0))
    run = case.run()
    tcomp = run.optimizer.compressor
    state = init_train_state(to_torch(jax.tree.map(np.asarray, params)),
                             run)
    assert (state.velocity is None) == (case.kind != "acgd")
    assert (state.downlink is None) == (case.downlink == "dense")
    if state.downlink is not None:
        assert state.downlink.gamma == f32(np.asarray(dl_gamma))
        assert tuple(state.downlink.memory.shape) == tuple(dl_mem.shape)
    assert (state.overlap is None) == (case.transport != "overlap")
    assert (state.gossip is None) == (case.transport != "gossip")
    if state.overlap is not None:
        assert tuple(state.overlap.payload.shape) == ov.payload.shape
        assert_overlap_close(ov, state.overlap, to_torch(
            jax.tree.map(np.asarray, params)), tcomp)
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=SEQ,
                         global_batch=BATCH)
    log = []
    for t in range(steps):
        batch = pipe.batch_with_aux(t, run.model)
        tparams = to_torch(jax.tree.map(np.asarray, params))
        state = dataclasses.replace(
            state, memory=to_torch(jax.tree.map(np.asarray, mem)))
        if state.velocity is not None:
            state = dataclasses.replace(
                state, velocity=to_torch(jax.tree.map(np.asarray, vel)))
        if state.downlink is not None:
            state = dataclasses.replace(state, downlink=DownlinkState(
                torch.from_numpy(np.array(dl_mem)), state.downlink.gamma))
        if state.overlap is not None:
            state = dataclasses.replace(state, overlap=to_port_overlap(ov))
        (params, mem, vel, dl_mem, ctx, jm, _, ov) = jstep(
            params, mem, vel, dl_mem, ctx,
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, ov)
        params, mem, vel, dl_mem, ov, ctx = _copy((params, mem, vel, dl_mem,
                                                   ov, ctx))
        tparams, state, m = train_step(tparams, state, batch, run)
        log.append(m)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["alpha"], float(jm["alpha"]),
                                   rtol=1e-5)
        assert m["n_evals"] == float(jm["n_evals"]), t
        if case.kind == "acgd":
            assert m["alpha"] == float(f32(case.eta)) and m["n_evals"] == 0
        assert f32(state.gamma).view(np.int32) == \
            np.asarray(ctx[2], np.float32).view(np.int32), t
        assert (m["wire_bytes"], m["effective_wire_bytes"]) == \
            (float(jm["wire"]), float(jm["eff"])), t
        assert m["cum_effective_wire_bytes"] == float(ctx[7]), t
        if case.downlink == "compressed":
            assert (m["downlink_wire_bytes"],
                    m["downlink_effective_wire_bytes"]) == \
                (float(jm["dl_wire"]), float(jm["dl_eff"])), t
            assert f32(state.downlink.gamma).view(np.int32) == \
                np.asarray(ctx[6], np.float32).view(np.int32), t
            assert_server_close(dl_mem, state.downlink.memory, tparams,
                                tcomp)
        else:
            assert "downlink_wire_bytes" not in m
        if case.transport == "overlap":
            assert m["staleness"] == float(jm["stale"]), t
            assert_overlap_close(ov, state.overlap, tparams, tcomp)
        else:
            assert "staleness" not in m
        if case.transport == "gossip":
            # one worker: no neighbour, a zero gossip error, v 0, lr 1
            assert_gossip_state(ov, state.gossip)
            assert float(state.gossip.v) == 0.0
            assert float(state.gossip.lr) == 1.0
        h = state.health
        assert (h.steps_skipped, h.consecutive_skips, h.last_good_step) \
            == (int(ctx[5].steps_skipped), int(ctx[5].consecutive_skips),
                int(ctx[5].last_good_step)), t
        assert_tree_close(params, tparams, params, f"step {t} params")
        assert_tree_close(mem, state.memory, params, f"step {t} memory")
        if case.kind == "acgd":
            assert_tree_close(vel, state.velocity, params,
                              f"step {t} velocity")
    return tparams, state, log


# ---- shared by tests/test_torch_overlap_train.py and
# tests/test_torch_overlap_runtime.py

def overlap_cases(H):
    """delay 0 and 1 for csgd_asss and nonadaptive, at H local steps."""
    return [Case(kind, transport="overlap", overlap_delay=delay,
                 local_steps=H, eta=0.1)
            for kind in ("csgd_asss", "nonadaptive") for delay in (0, 1)]


def check_overlap_rounds(case):
    """3 rounds against JAX; staleness 0, 1, 1 at delay 1, else 0."""
    _, state, log = run_both(case)
    stale = [m["staleness"] for m in log]
    assert stale == ([0.0, 1.0, 1.0] if case.overlap_delay else [0.0] * 3)
    assert state.overlap.seeded == 1.0


def overlap_run(delay=1, **opt):
    """The smoke RunConfig of csgd_asss on overlap, with ``opt``."""
    case = Case("csgd_asss", transport="overlap", overlap_delay=delay)
    run = case.run()
    return dataclasses.replace(run, optimizer=dataclasses.replace(
        run.optimizer, **opt)) if opt else run


def assert_bitwise_equal(a, b):
    """Two trees (dicts, dataclasses, tensors, host scalars) bit for bit."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_bitwise_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        for k in a:
            assert_bitwise_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    else:
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (a, b)


# ---- the gossip round on W workers (tests/test_torch_gossip_train.py)

#: the global batch of the W-worker rounds: 2 rows a worker at W = 4
GOSSIP_BATCH = 8


@functools.lru_cache(maxsize=None)
def jax_gossip_fns(case: Case, W: int):
    """``(pre, exchange, finish)`` of ``worker_fn``'s gossip round for W
    workers, jitted: ``pre`` one worker's gradients, search, gamma_t and
    eta (:685-741), outside any mesh; ``exchange`` the gossip exchange
    vmapped over the W workers; ``finish`` one worker's parameters, the
    breaker's gossip rule (the group's loss mean alone, :858-866) and
    its carried scalars."""
    model, params0 = jax_model()
    comp = JCompressor(**case.comp_kw())
    arm = JArmijo()
    ctrl = JGammaCfg(**case.ctrl_kw())
    topo = jbuild_topology(case.topology, W)
    gcfg = JGossipConfig(topology=case.topology)
    smask = model.stacked_mask(params0)

    def local_loss(params, batch):
        return model.loss(params, batch)[0]

    @jax.jit
    def pre(params, ctx, batch):
        alpha_prev, ema, gamma_prev, t, tel_prev = ctx[:5]
        loss, grads = jax.value_and_grad(local_loss)(params, batch)
        gsq = jsqnorm(grads)
        if case.kind == "csgd_asss":
            res = jarmijo(lambda p: local_loss(p, batch), params, grads,
                          jnext_alpha_max(alpha_prev, arm), arm,
                          grad_sqnorm=gsq)
            new_alpha = res.alpha
            new_ema = 0.9 * ema + 0.1 * res.n_evals.astype(jnp.float32)
            alpha_m, evals_m = res.alpha, res.n_evals.astype(jnp.float32)
            search = JSearch(alpha=res.alpha, alpha_prev=alpha_prev,
                             n_evals=res.n_evals, n_evals_ema=ema)
            eta_fn = lambda gt: arm.scale_for(gt) * res.alpha  # noqa: E731
        else:
            search = None
            new_alpha, new_ema = alpha_prev, ema
            alpha_m, evals_m = jnp.float32(case.eta), jnp.float32(0.0)
            eta_fn = lambda gt: jnp.float32(case.eta)  # noqa: E731
        gamma_t = jgamma_update(ctrl, comp, gamma_prev, t, search=search,
                                compression=tel_prev)
        return (loss, grads, eta_fn(gamma_t), gamma_t, new_alpha, new_ema,
                alpha_m, evals_m)

    exchange = jax.jit(jax.vmap(
        lambda g, m, e, gt, st: jwca(
            g, m, e, comp, ("data",), stacked_mask=smask, gamma_t=gt,
            transport="gossip", transport_ctx=JGossipCtx(topo, gcfg, st)),
        axis_name="data"))

    @jax.jit
    def finish(params, mem, gst, ctx, upd, new_mem, new_gst, loss_mean,
               eff_mean, new_alpha, new_ema, gamma_t, tel):
        (alpha_prev, ema, gamma_prev, t, tel_prev, health, dl_gamma,
         cum_eff) = ctx
        step_ok = jnp.isfinite(loss_mean)
        new_params = jax.tree.map(
            lambda p, u: jnp.where(step_ok, (p.astype(jnp.float32)
                                             - u).astype(p.dtype), p),
            params, upd)
        new_health = jadvance_health(health, step_ok, t, jnp.float32(0.0))
        new_cum = cum_eff + eff_mean
        new_ctx = (new_alpha, new_ema, gamma_t, t + 1, tel, new_health,
                   dl_gamma, new_cum)
        frozen = (alpha_prev, ema, gamma_prev, t + 1, tel_prev, new_health,
                  dl_gamma, new_cum)
        new_ctx, new_mem, new_gst = jax.tree.map(
            lambda a, b: jnp.where(step_ok, a, b),
            (new_ctx, new_mem, new_gst), (frozen, mem, gst))
        return new_params, new_mem, new_gst, new_ctx

    return pre, exchange, finish


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def run_gossip_workers(case: Case, W: int, steps: int = STEPS):
    """``steps`` gossip rounds of ``case`` on W workers through both
    packages from JAX's initial weights, checked round by round, each
    port worker from the reference's parameters and EF memory with its
    own carried scalars and (v, lr).  Returns the port's per-round
    results ``{rank: [dict]}``."""
    import pickle
    import tempfile

    import torch_gossip_workers as gw
    import torch_overlap_workers as ow
    model, params = jax_model()
    pre, exchange, finish = jax_gossip_fns(case, W)
    comp = JCompressor(**case.comp_kw())
    ctx0 = (jnp.float32(JArmijo().alpha0), jnp.float32(0.0),
            jgamma_init(JGammaCfg(**case.ctrl_kw()), comp), jnp.int32(0),
            JTel.init(), JHealth.init(), jnp.float32(0.0), jnp.float32(0.0))
    P = [params] * W
    M = [jax.tree.map(jnp.zeros_like, params)] * W
    G = [JGossipState.init()] * W
    C = [ctx0] * W
    B = GOSSIP_BATCH
    pipe = TokenPipeline(vocab_size=jax_smoke_config(ARCH).vocab_size,
                         seq_len=SEQ, global_batch=B)
    inputs = [[] for _ in range(W)]
    want = []
    for t in range(steps):
        tokens = pipe.batch(t)["tokens"]
        for w in range(W):
            inputs[w].append((_np(P[w]), _np(M[w])))
        outs = [pre(P[w], C[w], {"tokens": jnp.asarray(
            tokens[w * B // W:(w + 1) * B // W])}) for w in range(W)]
        stack = lambda i: jax.tree.map(  # noqa: E731
            lambda *x: jnp.stack(x), *[o[i] for o in outs])
        upd, new_mem, wire, eff, tel, new_g = exchange(
            stack(1), jax.tree.map(lambda *x: jnp.stack(x), *M), stack(2),
            stack(3), jax.tree.map(lambda *x: jnp.stack(x), *G))
        loss_mean = jnp.mean(stack(0))
        eff_mean = jnp.mean(eff)
        row = lambda tree, w: jax.tree.map(lambda x: x[w], tree)  # noqa
        for w in range(W):
            P[w], M[w], G[w], C[w] = _copy(finish(
                P[w], M[w], G[w], C[w], row(upd, w), row(new_mem, w),
                row(new_g, w), loss_mean, eff_mean, outs[w][4], outs[w][5],
                outs[w][3], row(tel, w)))
        want.append(dict(
            params=[_np(P[w]) for w in range(W)],
            mem=[_np(M[w]) for w in range(W)],
            gossip=[_np(G[w]) for w in range(W)],
            gamma=[np.float32(C[w][2]) for w in range(W)],
            health=[C[w][5] for w in range(W)],
            loss=float(loss_mean), wire=float(wire[0]),
            eff=float(eff_mean), cum=float(C[0][7]),
            alpha=float(jnp.mean(stack(6))),
            n_evals=float(jnp.mean(stack(7)))))
    with tempfile.TemporaryDirectory() as d:
        for w in range(W):
            with open(f"{d}/rank_{w}.pkl", "wb") as f:
                pickle.dump(inputs[w], f)
        got = ow.spawn(gw.gossip_trainer_rounds, W, case.run(), d, SEQ, B)
    for t, ref in enumerate(want):
        for w in range(W):
            p = got[w][t]
            where = f"round {t} rank {w}"
            assert_tree_close(ref["params"][w], to_torch(p["params"]),
                              ref["params"][w], f"{where} params")
            assert_tree_close(ref["mem"][w], to_torch(p["mem"]),
                              ref["params"][w], f"{where} memory")
            assert f32(p["gamma"]).view(np.int32) == \
                ref["gamma"][w].view(np.int32), where
            h = ref["health"][w]
            assert p["health"] == (int(h.steps_skipped),
                                   int(h.consecutive_skips),
                                   int(h.last_good_step)), where
            # v from each side's own gradients: rel 1e-4, as the float64
            # simulation of tests/distributed/test_gossip_exchange.py
            np.testing.assert_allclose(p["v"], ref["gossip"][w].v,
                                       rtol=1e-4, err_msg=where)
            assert p["lr"] == float(ref["gossip"][w].lr) == 1.0, where
            m = p["metrics"]
            np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["alpha"], ref["alpha"], rtol=1e-5)
            assert m["n_evals"] == ref["n_evals"], where
            assert (m["wire_bytes"], m["effective_wire_bytes"],
                    m["cum_effective_wire_bytes"]) == \
                (ref["wire"], ref["eff"], ref["cum"]), where
    return got


# ---- the federated cohort round (tests/test_torch_fed_train.py)

#: the cohort rounds' global batch: 2 rows a client at 4 clients
FED_BATCH = 8


@dataclasses.dataclass(frozen=True)
class FedCase:
    """One cohort configuration, in the terms both packages share; a
    fault campaign as FaultConfig keyword pairs."""

    kind: str = "csgd_asss"
    n_clients: int = 4
    sampling: str = "fixed"
    clients_per_round: int = 3
    rate: float = 1.0
    straggler: float = 0.0
    aggregation: str = "support"
    dirichlet_alpha: float = 0.0
    per_client_gamma: bool = True
    schedule: str = "fixed"
    gamma: float = GAMMA
    max_gamma: float = 0.0
    value_bits: int = 32
    eta: float = 0.1
    faults: tuple = ()
    arch: str = ARCH              # the smoke variant of this config

    def comp_kw(self):
        return dict(gamma=self.gamma, method="block_topk",
                    value_bits=self.value_bits, max_gamma=self.max_gamma)

    def fed_kw(self):
        return dict(n_clients=self.n_clients,
                    clients_per_round=self.clients_per_round,
                    sampling=self.sampling,
                    participation_rate=self.rate,
                    straggler_rate=self.straggler,
                    aggregation=self.aggregation,
                    per_client_gamma=self.per_client_gamma,
                    dirichlet_alpha=self.dirichlet_alpha)

    def run(self) -> RunConfig:
        from repro_torch.comm.faults import FaultConfig
        from repro_torch.configs.base import FederatedConfig
        return RunConfig(
            model=get_smoke_config(self.arch),
            shape=ShapeConfig(SEQ, FED_BATCH),
            optimizer=OptimizerConfig(
                kind=self.kind, eta=self.eta,
                compressor=Compressor(**self.comp_kw()),
                gamma_controller=GammaControllerConfig(
                    schedule=self.schedule, ramp_steps=2),
                federated=FederatedConfig(**self.fed_kw()),
                faults=FaultConfig(**dict(self.faults))))

    def mask(self, t):
        from repro_torch.fed.sampling import participation_mask
        return participation_mask(
            self.n_clients, t, mode=self.sampling,
            clients_per_round=self.clients_per_round, rate=self.rate,
            straggler_rate=self.straggler)

    def _pipes(self):
        return [TokenPipeline(
            vocab_size=jax_smoke_config(self.arch).vocab_size, seq_len=SEQ,
            global_batch=FED_BATCH, n_shards=self.n_clients, shard=c,
            dirichlet_alpha=self.dirichlet_alpha)
            for c in range(self.n_clients)]

    def tokens(self, t):
        """(n_clients, rows, SEQ) int32: client c is shard c of the
        (seed 0, step, shard) stream, Dirichlet-tilted, as the CLI's."""
        return np.stack([p.batch(t)["tokens"].numpy()
                         for p in self._pipes()])

    def aux(self, t) -> dict:
        """The batch's other keys, stacked per client as the CLI stacks
        them: an encoder-decoder's ``src_embed`` (n_clients, rows, SEQ,
        d_model) f32; {} for the other families."""
        cfg = get_smoke_config(self.arch)
        if cfg.family != "encdec":
            return {}
        return {"src_embed": np.stack(
            [p.batch_with_aux(t, cfg)["src_embed"].numpy()
             for p in self._pipes()])}


def _jax_cohort_round(case: FedCase):
    """One worker's round of ``_federated_worker`` (:511-636) for
    ``case`` at W = 1, written as the worker writes it, with the model
    outside any mesh and the exchange at ``dp_axes=None`` (equal to a
    one-device mesh: its gather and psum are identities).  ``fst``:
    (memory, gamma, rounds, alpha); ``ctx``: (step, health, cum_eff)."""
    from repro.comm.faults import FaultConfig as JFaultConfig
    from repro.comm.faults import active_faults as jactive_faults
    from repro.fed.clients import cohort_compress_aggregate as jcohort
    model, _ = jax_model(case.arch)
    comp = JCompressor(**case.comp_kw())
    arm = JArmijo()
    ctrl = JGammaCfg(schedule=case.schedule, ramp_steps=2)
    C = case.n_clients

    def local_loss(params, batch):
        return model.loss(params, batch)[0]

    def step(params, fst, ctx, tokens, mask, aux):
        memory, gamma, rounds, alpha = fst
        t, health, cum_eff = ctx
        cbatch = {"tokens": tokens, **aux}
        pl = mask
        n_part = jnp.maximum(jnp.sum(mask), 1.0)

        def wmean(x_c):
            return jnp.sum(pl * x_c) / n_part
        losses, grads_c = jax.vmap(
            lambda mb: jax.value_and_grad(local_loss)(params, mb))(cbatch)
        gsq_c = jax.vmap(jsqnorm)(grads_c)
        metrics = {"loss": wmean(losses), "grad_sqnorm": wmean(gsq_c),
                   "participants": jnp.sum(mask)}
        if case.per_client_gamma:
            gamma_t_c = jax.vmap(lambda g, r: jgamma_update(
                ctrl, comp, g, r))(gamma, rounds)
        else:
            gamma_t_c = jnp.broadcast_to(
                jgamma_update(ctrl, comp, gamma[0], t), (C,))
        gamma_used = jnp.where(pl > 0, gamma_t_c, gamma)
        metrics["gamma"] = wmean(gamma_used)
        if case.kind == "csgd_asss":
            res = jax.vmap(lambda mb, g, f0, gsq, amax: jarmijo(
                lambda p: local_loss(p, mb), params, g, amax, arm, f0=f0,
                grad_sqnorm=gsq))(cbatch, grads_c, losses, gsq_c,
                                  jnext_alpha_max(alpha, arm))
            alpha_c = res.alpha
            evals_c = res.n_evals.astype(jnp.float32)
            eta_c = jax.vmap(lambda g, a: arm.scale_for(g) * a)(
                gamma_used, alpha_c)
        else:
            alpha_c = jnp.full((C,), case.eta, jnp.float32)
            evals_c = jnp.zeros((C,), jnp.float32)
            eta_c = jnp.full((C,), case.eta, jnp.float32)
        metrics["alpha"] = wmean(alpha_c)
        metrics["n_evals"] = wmean(evals_c)

        def exchange():
            return jcohort(grads_c, memory, eta_c, comp, None, mask,
                           gamma_used, stacked_mask=model.stacked_mask(
                               params), aggregation=case.aggregation,
                           return_quarantined=True)
        if case.faults:
            with jactive_faults(JFaultConfig(**dict(case.faults)), t):
                updates, new_mem, wire, eff, quar = exchange()
        else:
            updates, new_mem, wire, eff, quar = exchange()
        new_params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) - u).astype(p.dtype),
            params, updates)
        step_ok = jnp.isfinite(metrics["loss"]) & jall_finite(updates)
        new_params = jax.tree.map(lambda a, b: jnp.where(step_ok, a, b),
                                  new_params, params)
        new_health = jadvance_health(health, step_ok, t, quar)
        cum = cum_eff + eff
        metrics.update(wire=wire, eff=eff, cum=cum, quar=quar,
                       step_ok=step_ok)
        new_fst = (new_mem, jnp.where(pl > 0, gamma_t_c, gamma),
                   rounds + (pl > 0).astype(jnp.int32),
                   jnp.where(pl > 0, alpha_c, alpha))
        new_fst = jax.tree.map(lambda a, b: jnp.where(step_ok, a, b),
                               new_fst, fst)
        return new_params, new_fst, (t + 1, new_health, cum), metrics

    return step


@functools.lru_cache(maxsize=None)
def jax_cohort_rounds(cases: tuple):
    """``STEPS`` cohort rounds of every case in ``cases`` through JAX,
    ONE jitted program over all of them (one compile), each case from
    JAX's initial weights and the zero client state: {case: [(inputs,
    outputs) per round]} as NumPy, the inputs the round's (params, fst,
    ctx, tokens, mask, aux)."""
    fns = [_jax_cohort_round(case) for case in cases]
    # keyed by position: a pytree's dict keys must sort
    fn = jax.jit(lambda ins: {i: f(*ins[i]) for i, f in enumerate(fns)})
    carry = {}
    for case in cases:
        params = jax_model(case.arch)[1]
        comp = JCompressor(**case.comp_kw())
        n = case.n_clients
        fst = (jax.tree.map(lambda p: jnp.zeros((n,) + p.shape, p.dtype),
                            params),
               jnp.full((n,), jgamma_init(JGammaCfg(
                   schedule=case.schedule, ramp_steps=2), comp),
                   jnp.float32),
               jnp.zeros((n,), jnp.int32),
               jnp.full((n,), JArmijo().alpha0, jnp.float32))
        carry[case] = (params, fst, (jnp.int32(0), JHealth.init(),
                                     jnp.float32(0.0)))
    rounds = {case: [] for case in cases}
    for t in range(STEPS):
        ins = [carry[case] + (jnp.asarray(case.tokens(t)),
                              jnp.asarray(case.mask(t)),
                              jax.tree.map(jnp.asarray, case.aux(t)))
               for case in cases]
        outs = fn(dict(enumerate(ins)))
        for i, case in enumerate(cases):
            rounds[case].append((_np(ins[i]), _np(outs[i])))
            carry[case] = _copy(outs[i][:3])
    return rounds


def armijo_sides(params, grads, mb, alpha, run):
    """Both sides of the Armijo condition at ``alpha`` on the port, for
    the client batch ``mb``: (f(x - alpha g), f(x) - sigma alpha
    ||g||^2), for a message."""
    from repro_torch.core.armijo import tree_sqnorm
    from repro_torch.models import build_model as tbuild_model
    from repro_torch.utils import tree_map as ttree_map
    loss = tbuild_model(run.model).loss
    f0 = loss(params, mb)
    cand = ttree_map(lambda p, g: p - float(alpha) * g, params, grads)
    return (float(loss(cand, mb)),
            float(f32(float(f0)) - f32(0.1) * f32(alpha)
                  * f32(float(tree_sqnorm(grads)))))


def run_fed_both(case: FedCase, cases: tuple):
    """``STEPS`` cohort rounds of ``case`` through both packages (JAX's
    in the one program of ``cases``), each port round from the
    reference's parameters and client state (EF memory, gamma, rounds,
    alpha), checked round by round.  Returns the port's per-round
    metrics."""
    from repro_torch.fed.clients import ClientState
    from repro_torch.utils import value_and_grad
    run = case.run()
    log = []
    state = None
    for t, (ins, outs) in enumerate(jax_cohort_rounds(cases)[case]):
        params, fst, ctx, tokens, mask, aux = ins
        new_params, new_fst, new_ctx, jm = outs
        tparams = to_torch(params)
        if state is None:
            state = init_train_state(tparams, run)
            assert state.memory is None and state.fed is not None
        state = dataclasses.replace(state, fed=ClientState(
            memory=to_torch(fst[0]), gamma=torch.from_numpy(fst[1]),
            rounds=torch.from_numpy(fst[2]),
            alpha=torch.from_numpy(fst[3])))
        batch = {"tokens": torch.from_numpy(tokens),
                 **{k: torch.from_numpy(v) for k, v in aux.items()}}
        tp, state, m = train_step(
            tparams, state, {**batch, "participation": mask}, run)
        log.append(m)
        where = f"{case} round {t}"
        np.testing.assert_allclose(m["loss"], float(jm["loss"]),
                                   rtol=1e-5, err_msg=where)
        np.testing.assert_allclose(m["grad_sqnorm"],
                                   float(jm["grad_sqnorm"]), rtol=1e-5,
                                   err_msg=where)
        assert m["participants"] == float(jm["participants"]), where
        for c in range(case.n_clients):
            a, b = float(state.fed.alpha[c]), float(new_fst[3][c])
            if abs(a - b) > 1e-5 * abs(b):
                from repro_torch.models import build_model as tbuild_model
                mb = {k: v[c] for k, v in batch.items()}
                _, g = value_and_grad(lambda p: tbuild_model(
                    run.model).loss(p, mb), tparams)
                raise AssertionError(
                    f"{where} client {c}: alpha {a} vs JAX {b}; "
                    f"Armijo sides (f_try, rhs) at the port's alpha "
                    f"{armijo_sides(tparams, g, mb, a, run)}, at "
                    f"JAX's {armijo_sides(tparams, g, mb, b, run)}")
        np.testing.assert_allclose(m["alpha"], float(jm["alpha"]),
                                   rtol=1e-5, err_msg=where)
        assert m["n_evals"] == float(jm["n_evals"]), where
        np.testing.assert_array_max_ulp(
            f32(m["gamma"]), np.float32(jm["gamma"]), maxulp=8)
        np.testing.assert_array_equal(
            state.fed.gamma.numpy().view(np.int32),
            np.asarray(new_fst[1], np.float32).view(np.int32),
            err_msg=where)
        np.testing.assert_array_equal(state.fed.rounds.numpy(),
                                      new_fst[2], err_msg=where)
        assert (m["wire_bytes"], m["effective_wire_bytes"],
                m["cum_effective_wire_bytes"]) == \
            (float(jm["wire"]), float(jm["eff"]), float(jm["cum"])), \
            where
        h = new_ctx[1]
        assert (state.health.steps_skipped,
                state.health.consecutive_skips,
                state.health.last_good_step,
                float(state.health.rows_quarantined)) == \
            (int(h.steps_skipped), int(h.consecutive_skips),
             int(h.last_good_step), float(h.rows_quarantined)), where
        assert (m["ef_backlog"], m["ef_cosine"]) == (0.0, 1.0)
        assert_tree_close(new_params, tp, params, f"{where} params")
        _assert_memory_close(new_fst[0], state.fed.memory, params,
                             where)
    return log


def _assert_memory_close(jmem, tmem, params, where):
    """Every client's EF memory within 1e-5 of the leaf's max |p|."""
    for k, v in jmem.items():
        if isinstance(v, dict):
            _assert_memory_close(v, tmem[k], params[k], f"{where}/{k}")
            continue
        err = float(np.abs(np.asarray(v) - tmem[k].numpy()).max())
        scale = float(np.abs(np.asarray(params[k])).max())
        assert err <= 1e-5 * scale, f"{where} memory/{k}: {err} vs " \
            f"max|p| {scale}"
