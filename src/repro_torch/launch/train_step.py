"""The data-parallel DCSGD-ASSS train step (twin of the ``csgd_asss``
subset of ``worker_fn`` in ``src/repro/launch/train_step.py``).

Each worker — one process of the data-parallel group, one device —

  grads  <- autograd over its batch
  alpha  <- Armijo search on the same batch             (Algorithm 3 l.4)
  gamma  <- the gamma controller's round (core/gamma.py)
  eta    <- scale_for(gamma) * alpha
  update <- compress + all-gather the packed payload     (Algorithm 3 l.5-7)
  params <- params - update, unless the loss or the update is non-finite

The controller reads this round's search and this worker's own
compression telemetry of the previous round, which the previous step
read back with its metrics in one transfer; workers may so compress at
different gamma_t, and every row is decoded at its own count.

The finite check skips the step as the JAX package's breaker does: the
parameters and every carried optimizer quantity stay as they were, while
the step counter and the byte counters advance.  The host-side
``DivergenceError`` after many consecutive skips and gradient
accumulation over microbatches are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comm.exchange import all_reduce_mean
from repro_torch.core.armijo import armijo_search, next_alpha_max, \
    next_evals_ema, tree_sqnorm
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.core.error_feedback import init_ef
from repro_torch.core.gamma import gamma_init, gamma_update
from repro_torch.core.telemetry import CompressionTelemetry, SearchTelemetry
from repro_torch.models import lm
from repro_torch.utils import tree_leaves, tree_map, value_and_grad

f32 = np.float32

METRIC_KEYS = ("loss", "grad_sqnorm", "alpha", "n_evals", "gamma",
               "wire_bytes", "effective_wire_bytes", "ef_backlog",
               "ef_cosine")
TELEMETRY_FIELDS = ("ef_backlog", "cosine", "decode_error", "eff_gamma")


@dataclasses.dataclass(frozen=True)
class TrainState:
    """One worker's optimizer state (the JAX ``DistOptState`` without its
    leading worker axis: each process holds its own)."""

    step: int
    alpha_prev: np.float32
    memory: dict                  # EF memory, f32 leaves like params
    n_evals_ema: np.float32
    gamma: np.float32
    telemetry: CompressionTelemetry  # own previous round, host float32
    cum_wire_bytes: np.float32
    cum_eff_bytes: np.float32
    steps_skipped: int


def init_train_state(params, run_cfg) -> TrainState:
    opt = run_cfg.optimizer
    return TrainState(
        step=0, alpha_prev=f32(opt.armijo.alpha0),
        memory=init_ef(params),
        n_evals_ema=f32(0.0),
        gamma=gamma_init(opt.gamma_controller, opt.compressor),
        # neutral: zero backlog, perfect alignment
        telemetry=CompressionTelemetry(ef_backlog=f32(0.0), cosine=f32(1.0),
                                       decode_error=f32(0.0),
                                       eff_gamma=f32(1.0)),
        cum_wire_bytes=f32(0.0), cum_eff_bytes=f32(0.0), steps_skipped=0)


def _all_finite(tree) -> torch.Tensor:
    ok = None
    for leaf in tree_leaves(tree):
        f = torch.isfinite(leaf).all()
        ok = f if ok is None else ok & f
    return ok


def train_step(params, state: TrainState, batch: dict, run_cfg, group=None):
    """One step on this worker's local ``batch``.  Returns
    ``(params, state, metrics)``; metrics are means over the group, as
    host floats."""
    opt = run_cfg.optimizer
    cfg = run_cfg.model
    # the spans split a step's host time for a profiler (chip_smoke.py)
    with record_function("train_step.grad"):
        loss, grads = value_and_grad(
            lambda p: lm.loss_fn(p, batch, cfg), params)
        gsq = tree_sqnorm(grads)
    with record_function("train_step.armijo"):
        res = armijo_search(lambda p: lm.loss_fn(p, batch, cfg), params,
                            grads, next_alpha_max(state.alpha_prev,
                                                  opt.armijo),
                            opt.armijo, f0=loss, grad_sqnorm=gsq)
    gamma_t = gamma_update(
        opt.gamma_controller, opt.compressor, state.gamma, state.step,
        search=SearchTelemetry(alpha=res.alpha, alpha_prev=state.alpha_prev,
                               n_evals=f32(res.n_evals),
                               n_evals_ema=state.n_evals_ema),
        compression=state.telemetry)
    eta = opt.armijo.scale_for(gamma_t) * res.alpha
    with record_function("train_step.exchange"):
        updates, new_mem, wire, eff, tel = worker_compress_aggregate(
            grads, state.memory, eta, opt.compressor, group,
            stacked_mask=lm.stacked_mask(params), gamma_t=gamma_t,
            transport=opt.transport)

    with record_function("train_step.metrics"):
        local = torch.stack(
            [loss.float(), gsq.float()]
            + [torch.tensor(float(x), device=loss.device)
               for x in (res.alpha, res.n_evals, gamma_t, wire, eff)]
            + [tel.ef_backlog, tel.cosine])
        # one host transfer: the group means and this worker's own
        # telemetry, which the next round's controller reads
        own = torch.stack([getattr(tel, f) for f in TELEMETRY_FIELDS])
        values = torch.cat([all_reduce_mean(local, group), own]).tolist()
        metrics = dict(zip(METRIC_KEYS, values))
        tel = CompressionTelemetry(*map(f32, values[len(METRIC_KEYS):]))
    cum_wire = state.cum_wire_bytes + f32(metrics["wire_bytes"])
    cum_eff = state.cum_eff_bytes + f32(metrics["effective_wire_bytes"])
    metrics["cum_wire_bytes"] = float(cum_wire)
    metrics["cum_effective_wire_bytes"] = float(cum_eff)

    # the decoded aggregate is the same on every worker, so the gate
    # needs no collective beyond the loss mean above
    step_ok = bool(np.isfinite(metrics["loss"])) and bool(
        _all_finite(updates))
    skipped = state.steps_skipped + (0 if step_ok else 1)
    metrics["steps_skipped"] = float(skipped)
    if not step_ok:
        return params, dataclasses.replace(
            state, step=state.step + 1, cum_wire_bytes=cum_wire,
            cum_eff_bytes=cum_eff, steps_skipped=skipped), metrics
    new_params = tree_map(lambda p, u: (p.float() - u).to(p.dtype),
                          params, updates)
    return new_params, TrainState(
        step=state.step + 1, alpha_prev=res.alpha, memory=new_mem,
        n_evals_ema=next_evals_ema(state.n_evals_ema, res.n_evals),
        gamma=gamma_t, telemetry=tel, cum_wire_bytes=cum_wire,
        cum_eff_bytes=cum_eff, steps_skipped=skipped), metrics
