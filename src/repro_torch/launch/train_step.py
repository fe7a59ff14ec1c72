"""The data-parallel train step (twin of the plain body of ``worker_fn``
in ``src/repro/launch/train_step.py``, its acgd round, compressed
downlink, overlap, gossip and fault seams, and its local-steps round,
``_local_steps_worker``: no federated cohort or shard-local top-k).

Each worker — one process of the data-parallel group, one device —

  grads  <- autograd over its batch, summed over its microbatches
  alpha  <- Armijo search on the first microbatch        (Algorithm 3 l.4)
            (csgd_asss, sls; the other kinds step at a constant eta)
  gamma  <- the gamma controller's round (core/gamma.py)
  eta    <- scale_for(gamma) * alpha, or eta
  send   <- grads, or for acgd the Nesterov direction mu*v' + g with
            v' = mu*v + g (this worker's own velocity, f32)
  update <- compress + all-gather the packed payload     (Algorithm 3 l.5-7)
            (csgd_asss, nonadaptive, acgd), or a dense all-reduce (sls,
            sgd, dense)
  update <- with ``downlink="compressed"``, the server's EF re-compression
            of the mean update at the downlink's own gamma_t, the same
            on every worker (comm/downlink.py), with no extra collective
  params <- params - update, unless the loss or the update is non-finite

The controller reads this round's search and this worker's own
compression telemetry of the previous round, which the previous step
read back with its metrics in one transfer; workers may so compress at
different gamma_t, and every row is decoded at its own count.

With ``local_steps`` H > 1 a compressing kind instead takes H local
Armijo-SGD steps, one on each of H microbatches, and exchanges the model
delta once at eta 1 through the same EF compression and kernels
(``_local_steps_step``): one exchange per H model updates.

The EF memory is f32 or bf16 (``OptimizerConfig.ef_dtype``); every
transport reads it as f32 and writes m' back with one rounding.

Under ``transport="overlap"`` (``comm/overlap.py``) ``TrainState.overlap``
carries the previous round's payload and dense accumulators.  At
``delay=1`` the step posts their collectives (the ring's hops and the
dense all-reduce) first, in a ``train_step.overlap_start`` span, before
the gradient or the local steps; the exchange waits on them when it
decodes and applies that one-round-old aggregate.  The metrics add
``staleness``, ``delay * seeded`` of the incoming state: 0 on the
warm-up round (the zero payload, a zero update) and at ``delay=0``,
else 1.

Under ``transport="gossip"`` (``comm/gossip.py``) workers' models
genuinely diverge: each rank's ``params`` are its own model (JAX keeps
them in ``DistOptState.gossip.params[w]`` beside a frozen common
initialization; the port's ranks already hold their own), and
``TrainState.gossip`` carries its AdaGossip ``(v, lr)``.  The topology
is built once per (name, group size).  The updates are per worker, so
the breaker's gate reads the group's loss mean alone, as JAX's does.

With a fault campaign (``OptimizerConfig.faults`` with a nonzero rate)
every exchange — the plain round's, the local-steps round's, overlap's
and gossip's — runs through the ``faulty`` wrapper transport
(``comm/faults.py``, JAX's ``wrap_faults``), keyed on the round index
``TrainState.step``; the decode verdicts run on every transport unless
the campaign sets ``quarantine=False``.  The round's quarantined-row
count rides the metrics' one host transfer into
``HealthState.rows_quarantined``; the ``rows_quarantined`` metric is
this worker's cumulative count, under gossip (each worker verdicts its
own neighbours' rows) the group's mean of it, as JAX's is.

Under the downlink the metrics add ``downlink_wire_bytes`` and
``downlink_effective_wire_bytes``; ``cum_effective_wire_bytes`` then
prices both directions, ``(previous + uplink) + downlink`` with each sum
rounded to f32 as JAX's does, and the port's own ``cum_wire_bytes``
adds the downlink's static bytes in the same order.

The finite check is the JAX package's breaker (core/health.py): with
``max_consecutive_skips > 0`` a failed check skips the step — the
parameters and every carried optimizer quantity stay as they were, while
the step counter, the byte counters and the health counters advance —
and the caller raises ``DivergenceError`` after that many consecutive
skips (``check_divergence``); with 0 non-finite rounds write through.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.comm.downlink import DownlinkCtx, DownlinkState, \
    init_downlink_state
from repro_torch.comm.exchange import all_reduce_mean
from repro_torch.comm.faults import FaultCtx
from repro_torch.comm.gossip import GossipCtx, GossipState
from repro_torch.comm.overlap import OverlapCtx, OverlapState, \
    init_overlap_state, post_carried
from repro_torch.comm.topology import Topology, build_topology
from repro_torch.configs.base import COMPRESSING, LOCAL_STEP_KINDS, \
    SEARCHING
from repro_torch.core.acgd import nesterov
from repro_torch.core.armijo import armijo_search, local_evals_ema, \
    next_alpha_max, next_evals_ema, reciprocal_product, tree_sqnorm
from repro_torch.core.dcsgd import dense_aggregate, worker_compress_aggregate
from repro_torch.core.error_feedback import init_ef
from repro_torch.core.gamma import gamma_init, gamma_update
from repro_torch.core.health import HealthState, advance_health, all_finite
from repro_torch.core.telemetry import CompressionTelemetry, SearchTelemetry
from repro_torch.models import lm
from repro_torch.utils import tree_flatten, tree_map, value_and_grad

f32 = np.float32

METRIC_KEYS = ("loss", "grad_sqnorm", "alpha", "n_evals", "gamma",
               "wire_bytes", "effective_wire_bytes", "ef_backlog",
               "ef_cosine")
DOWNLINK_KEYS = ("downlink_wire_bytes", "downlink_effective_wire_bytes")
OVERLAP_KEYS = ("staleness",)
TELEMETRY_FIELDS = ("ef_backlog", "cosine", "decode_error", "eff_gamma",
                    "rows_quarantined")


@dataclasses.dataclass(frozen=True)
class TrainState:
    """One worker's optimizer state (the JAX ``DistOptState`` without its
    leading worker axis: each process holds its own)."""

    step: int
    alpha_prev: np.float32
    memory: dict | None           # EF memory, leaves like params in
                                  # ef_dtype (f32 or bf16); None for the
                                  # kinds that do not compress
    n_evals_ema: np.float32
    gamma: np.float32
    telemetry: CompressionTelemetry  # own previous round, host float32
    cum_wire_bytes: np.float32
    cum_eff_bytes: np.float32
    health: HealthState
    velocity: dict | None = None     # acgd: the Nesterov buffer, f32
                                     # leaves like params
    downlink: DownlinkState | None = None  # the server's state under
                                           # downlink="compressed"
    overlap: OverlapState | None = None    # the carried payload under
                                           # transport="overlap"
    gossip: GossipState | None = None      # the AdaGossip (v, lr) under
                                           # transport="gossip"


def init_train_state(params, run_cfg) -> TrainState:
    opt = run_cfg.optimizer
    downlink = overlap = gossip = None
    leaves = tree_flatten(params)[0]
    # the geometry the exchange uses: leaf shapes and lm.stacked_mask
    shapes = [p.shape for p in leaves]
    stacked = tree_flatten(lm.stacked_mask(params))[0]
    if opt.kind in COMPRESSING and opt.downlink == "compressed":
        downlink = init_downlink_state(
            shapes, stacked, opt.compressor,
            opt.downlink_gamma.resolve(opt.compressor)[0],
            device=leaves[0].device)
    if opt.kind in COMPRESSING and opt.transport == "overlap":
        overlap = init_overlap_state(shapes, stacked, opt.compressor,
                                     device=leaves[0].device)
    if opt.kind in COMPRESSING and opt.transport == "gossip":
        gossip = GossipState.init(leaves[0].device)
    return TrainState(
        step=0, alpha_prev=f32(opt.armijo.alpha0),
        memory=init_ef(params, getattr(torch, opt.ef_dtype))
        if opt.kind in COMPRESSING else None,
        n_evals_ema=f32(0.0),
        gamma=gamma_init(opt.gamma_controller, opt.compressor),
        # neutral: zero backlog, perfect alignment
        telemetry=CompressionTelemetry(ef_backlog=f32(0.0), cosine=f32(1.0),
                                       decode_error=f32(0.0),
                                       eff_gamma=f32(1.0),
                                       rows_quarantined=f32(0.0)),
        cum_wire_bytes=f32(0.0), cum_eff_bytes=f32(0.0),
        health=HealthState(),
        velocity=tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        if opt.kind == "acgd" else None,
        downlink=downlink, overlap=overlap, gossip=gossip)


def microbatch_mean(total: torch.Tensor, micro: int) -> torch.Tensor:
    """``total / micro`` in place, as jitted XLA divides by a constant:
    a product with f32(1/micro), which differs from a division in the
    last bit for a third of f32 values at micro 3."""
    return total.mul_(float(f32(1.0) / f32(micro)))


def _accumulated_grads(params, batch: dict, cfg, micro: int):
    """``(loss, grads, probe, f0)`` over ``micro`` row groups of the
    local batch: loss and grads summed in f32 from zero in microbatch
    order, then their mean; ``probe`` is the first microbatch and ``f0``
    its loss, where the Armijo search runs."""
    if micro == 1:
        loss, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                     params)
        return loss, grads, batch, loss
    n = next(iter(batch.values())).shape[0]
    if n % micro:
        raise ValueError(f"the local batch of {n} rows does not split into "
                         f"{micro} microbatches")
    rows = n // micro
    loss_sum, grads, probe, f0 = None, None, None, None
    for i in range(micro):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        lo, g = value_and_grad(lambda p: lm.loss_fn(p, mb, cfg), params)
        if i == 0:
            probe, f0 = mb, lo
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=lo.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        loss_sum = loss_sum + lo
        tree_map(lambda acc, x: acc.add_(x), grads, g)
        del g
    return microbatch_mean(loss_sum, micro), tree_map(
        lambda x: microbatch_mean(x, micro), grads), probe, f0


def train_step(params, state: TrainState, batch: dict, run_cfg, group=None):
    """One step on this worker's local ``batch``.  Returns
    ``(params, state, metrics)``; metrics are means over the group, as
    host floats, and this worker's health counters.  With
    ``local_steps > 1`` ``csgd_asss`` and ``nonadaptive`` take the
    local-steps round (``_local_steps_step``), exactly where JAX's
    ``worker_fn`` does; ``sls``, ``sgd`` and ``dense`` ignore
    ``local_steps``, as JAX's do (acgd and the downlink refuse it)."""
    opt = run_cfg.optimizer
    started = _overlap_start(state, opt, group)
    if opt.local_steps > 1 and opt.kind in LOCAL_STEP_KINDS:
        return _local_steps_step(params, state, batch, run_cfg, group,
                                 started)
    cfg = run_cfg.model
    # the spans split a step's host time for a profiler (chip_smoke.py)
    with record_function("train_step.grad"):
        loss, grads, probe, f0 = _accumulated_grads(
            params, batch, cfg, run_cfg.microbatches)
        gsq = tree_sqnorm(grads)
    if opt.kind in SEARCHING:
        with record_function("train_step.armijo"):
            res = armijo_search(lambda p: lm.loss_fn(p, probe, cfg), params,
                                grads, next_alpha_max(state.alpha_prev,
                                                      opt.armijo),
                                opt.armijo, f0=f0, grad_sqnorm=gsq)
        alpha, n_evals = res.alpha, res.n_evals
        search = SearchTelemetry(alpha=alpha, alpha_prev=state.alpha_prev,
                                 n_evals=f32(n_evals),
                                 n_evals_ema=state.n_evals_ema)
        new_alpha, new_ema = alpha, next_evals_ema(state.n_evals_ema,
                                                   n_evals)
    else:
        alpha, n_evals, search = f32(opt.eta), 0, None
        new_alpha, new_ema = state.alpha_prev, state.n_evals_ema
    gamma_t = gamma_update(
        opt.gamma_controller, opt.compressor, state.gamma, state.step,
        search=search, compression=state.telemetry)
    # the scaled step of both searching kinds, sls included (the
    # trainer's rule, not core/baselines.SLS's a = 1)
    eta = opt.armijo.scale_for(gamma_t) * alpha if search is not None \
        else alpha
    dl_res, new_ov, new_gs, new_vel = None, None, None, state.velocity
    with record_function("train_step.exchange"):
        if opt.kind in COMPRESSING:
            send = grads
            if opt.kind == "acgd":
                # the Nesterov round: the exchange ships mu*v' + g, and
                # the gradients are not needed past it
                new_vel, send = nesterov(state.velocity, grads,
                                         opt.momentum)
                del grads
            ctx = None
            if state.downlink is not None:
                # the server round's gamma_t, advanced before the exchange
                ctx = DownlinkCtx(DownlinkState(
                    state.downlink.memory, gamma_update(
                        opt.downlink_gamma, opt.compressor,
                        state.downlink.gamma, state.step)))
            name, t_ctx = _transport(state, opt, started, group)
            out = worker_compress_aggregate(
                send, state.memory, eta, opt.compressor, group,
                stacked_mask=lm.stacked_mask(params), gamma_t=gamma_t,
                transport=name, transport_ctx=t_ctx, downlink_ctx=ctx)
            del send
            updates, new_mem, wire, eff, tel = out[:5]
            if ctx is not None:
                dl_res = out[5]
            if state.overlap is not None:
                new_ov = out[5]
            if state.gossip is not None:
                new_gs = out[5]
        else:
            updates, wire = dense_aggregate(grads, eta, group)
            eff, new_mem = wire, state.memory
            # no compression: the telemetry is carried unchanged
            tel = CompressionTelemetry(*(
                torch.tensor(float(getattr(state.telemetry, f)),
                             device=loss.device) for f in TELEMETRY_FIELDS))
    return _finish_round(
        params, state, run_cfg, group, loss=loss, gsq=gsq, alpha=alpha,
        n_evals=n_evals, gamma_t=gamma_t, updates=updates, new_mem=new_mem,
        wire=wire, eff=eff, tel=tel, new_alpha=new_alpha, new_ema=new_ema,
        new_vel=new_vel, dl_res=dl_res, new_ov=new_ov, new_gs=new_gs)


def _overlap_start(state: TrainState, opt, group):
    """Under the overlap transport at ``delay=1``: post the carried
    buffers' collectives now, before any of the round's compute (None
    otherwise)."""
    if state.overlap is None or opt.overlap.delay != 1:
        return None
    with record_function("train_step.overlap_start"):
        return post_carried(state.overlap, group, opt.overlap.n_chunks)


@functools.lru_cache(maxsize=8)
def _topology(name: str, W: int) -> Topology:
    """The gossip graph over the group's W workers, built once."""
    return build_topology(name, W)


def _transport(state: TrainState, opt, started, group):
    """The exchange's transport and ``transport_ctx``: the overlap or
    gossip transport's context with its carried state (None for the
    stateless ones), wrapped in the ``faulty`` transport when a fault
    campaign is configured (JAX's ``wrap_faults``), keyed on the round
    index."""
    ctx = None
    if state.overlap is not None:
        ctx = OverlapCtx(opt.overlap, state.overlap, started)
    elif state.gossip is not None:
        ctx = GossipCtx(_topology(opt.gossip.topology,
                                  dist.get_world_size(group)),
                        opt.gossip, state.gossip)
    if not opt.faults.enabled:
        return opt.transport, ctx
    return "faulty", FaultCtx(cfg=opt.faults, step=state.step,
                              inner=opt.transport, inner_ctx=ctx)


def _local_steps_step(params, state: TrainState, batch: dict, run_cfg,
                      group=None, started=None):
    """The twin of JAX's ``_local_steps_worker``: H = ``local_steps``
    Armijo-SGD steps on this worker's H microbatches (rows ``[i*B/H,
    (i+1)*B/H)``, JAX's reshape), then ONE EF-compressed exchange of the
    model delta at eta 1.

    Each local step searches from the ``alpha_max`` the previous one
    carried, with its own loss as f0, and steps by ``a_scale * alpha``
    (no theory-safe clamp: gamma_t is known only after the H steps) —
    for ``nonadaptive`` too, as JAX's worker has no branch on the kind.
    The local update ``p - eta*g`` rounds once, as jitted XLA contracts
    it (``torch.add`` with ``alpha`` is one fused multiply-add on the
    CPU).  The carried scalars follow jitted XLA bit for bit:
    ``alpha_prev = amax / omega`` and ``evals / H`` are products with a
    reciprocal, the running mean is ``local_evals_ema``."""
    opt = run_cfg.optimizer
    cfg = run_cfg.model
    H = opt.local_steps
    n = next(iter(batch.values())).shape[0]
    if n % H:
        raise ValueError(f"the local batch of {n} rows does not split into "
                         f"{H} local steps")
    rows = n // H
    p_loc, amax, evals = params, next_alpha_max(state.alpha_prev,
                                                opt.armijo), f32(0.0)
    loss_sum, alpha = None, None
    for i in range(H):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        with record_function("train_step.local_step"):
            lo, g = value_and_grad(lambda p: lm.loss_fn(p, mb, cfg), p_loc)
            res = armijo_search(lambda p: lm.loss_fn(p, mb, cfg), p_loc, g,
                                amax, opt.armijo, f0=lo,
                                grad_sqnorm=tree_sqnorm(g))
            eta = float(f32(opt.armijo.a_scale) * res.alpha)
            p_loc = tree_map(lambda p, gg: torch.add(
                p.float(), gg.float(), alpha=-eta).to(p.dtype), p_loc, g)
            del g
        amax = next_alpha_max(res.alpha, opt.armijo)
        evals = f32(evals + f32(res.n_evals))
        alpha = res.alpha
        loss_sum = lo.float() if loss_sum is None else loss_sum + lo
    evals_mean = reciprocal_product(evals, H)
    gamma_t = gamma_update(
        opt.gamma_controller, opt.compressor, state.gamma, state.step,
        search=SearchTelemetry(alpha=alpha, alpha_prev=state.alpha_prev,
                               n_evals=evals_mean,
                               n_evals_ema=state.n_evals_ema),
        compression=state.telemetry)
    with record_function("train_step.exchange"):
        delta = tree_map(lambda a, b: a.float() - b.float(), params, p_loc)
        del p_loc
        # the overlap seam: at delay 1 the carried payload's collectives,
        # posted before the H local steps, ship during them
        name, t_ctx = _transport(state, opt, started, group)
        out = worker_compress_aggregate(
            delta, state.memory, f32(1.0), opt.compressor, group,
            stacked_mask=lm.stacked_mask(params), gamma_t=gamma_t,
            transport=name, transport_ctx=t_ctx)
        del delta
        updates, new_mem, wire, eff, tel = out[:5]
    return _finish_round(
        params, state, run_cfg, group,
        loss=microbatch_mean(loss_sum, H),
        gsq=torch.zeros((), device=loss_sum.device), alpha=alpha,
        n_evals=evals_mean, gamma_t=gamma_t, updates=updates,
        new_mem=new_mem, wire=wire, eff=eff, tel=tel,
        new_alpha=reciprocal_product(amax, opt.armijo.omega),
        new_ema=local_evals_ema(state.n_evals_ema, evals, H),
        new_ov=out[5] if state.overlap is not None else None)


def _finish_round(params, state: TrainState, run_cfg, group, *, loss, gsq,
                  alpha, n_evals, gamma_t, updates, new_mem, wire, eff, tel,
                  new_alpha, new_ema, new_vel=None, dl_res=None,
                  new_ov=None, new_gs=None):
    """The round's metrics (one host transfer), the breaker and the new
    state, shared by the plain and the local-steps round.  ``dl_res``:
    the downlink's ``DownlinkResult``, or None; ``new_ov`` / ``new_gs``:
    the overlap / gossip transport's new state, or None."""
    opt = run_cfg.optimizer
    keys = METRIC_KEYS + (DOWNLINK_KEYS if dl_res is not None else ()) \
        + (OVERLAP_KEYS if new_ov is not None else ())
    # JAX: f32(delay) * seeded of the incoming state, then the mean
    stale = [f32(opt.overlap.delay) * state.overlap.seeded] \
        if new_ov is not None else []
    compressing = opt.kind in COMPRESSING
    # under gossip the metric is the group's mean of each worker's new
    # cumulative count (the f32 sum advance_health forms), as JAX's
    quar_mean = []
    if new_gs is not None:
        keys = keys + ("rows_quarantined",)
        quar_mean = [torch.full((), float(state.health.rows_quarantined),
                                device=loss.device) + tel.rows_quarantined]
    with record_function("train_step.metrics"):
        local = torch.stack(
            [loss.float(), gsq.float()]
            + [torch.tensor(float(x), device=loss.device)
               for x in (alpha, n_evals, gamma_t, wire, eff)]
            + [tel.ef_backlog, tel.cosine]
            + [torch.tensor(float(x), device=loss.device)
               for x in (list(dl_res[1:]) if dl_res is not None else [])
               + stale] + quar_mean)
        # one host transfer: the group means and this worker's own
        # telemetry, which the next round's controller reads
        own = torch.stack([getattr(tel, f) for f in TELEMETRY_FIELDS])
        values = torch.cat([all_reduce_mean(local, group), own]).tolist()
        metrics = dict(zip(keys, values))
        tel = CompressionTelemetry(*map(f32, values[len(keys):]))
    cum_wire = state.cum_wire_bytes + f32(metrics["wire_bytes"])
    cum_eff = state.cum_eff_bytes + f32(metrics["effective_wire_bytes"])
    new_downlink = state.downlink
    if dl_res is not None:
        # both directions: (previous + uplink) + downlink, each in f32
        cum_wire = cum_wire + f32(metrics["downlink_wire_bytes"])
        cum_eff = cum_eff + f32(metrics["downlink_effective_wire_bytes"])
        new_downlink = dl_res.state
    metrics["cum_wire_bytes"] = float(cum_wire)
    metrics["cum_effective_wire_bytes"] = float(cum_eff)

    # the decoded aggregate is the same on every worker, so the gate
    # needs no collective beyond the loss mean above; under gossip the
    # updates are per worker, and the loss mean alone gates (a NaN
    # anywhere poisons the mean within one round), as JAX's does
    step_ok = bool(np.isfinite(metrics["loss"])) and (
        new_gs is not None or bool(all_finite(updates)))
    # the round's quarantined rows came back with the metrics above
    health = advance_health(state.health, step_ok, state.step,
                            tel.rows_quarantined if compressing else 0.0)
    metrics.update(steps_skipped=float(health.steps_skipped),
                   consecutive_skips=float(health.consecutive_skips),
                   last_good_step=float(health.last_good_step))
    metrics.setdefault("rows_quarantined", float(health.rows_quarantined))
    if not step_ok and opt.max_consecutive_skips > 0:
        return params, dataclasses.replace(
            state, step=state.step + 1, cum_wire_bytes=cum_wire,
            cum_eff_bytes=cum_eff, health=health), metrics
    new_params = tree_map(lambda p, u: (p.float() - u).to(p.dtype),
                          params, updates)
    return new_params, TrainState(
        step=state.step + 1, alpha_prev=new_alpha, memory=new_mem,
        n_evals_ema=new_ema, gamma=gamma_t, telemetry=tel,
        cum_wire_bytes=cum_wire, cum_eff_bytes=cum_eff,
        health=health,
        velocity=state.velocity if new_vel is None else new_vel,
        downlink=new_downlink,
        overlap=state.overlap if new_ov is None else new_ov,
        gossip=state.gossip if new_gs is None else new_gs), metrics
