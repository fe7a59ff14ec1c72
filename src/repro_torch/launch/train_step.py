"""The data-parallel DCSGD-ASSS train step (twin of the ``csgd_asss``
subset of ``worker_fn`` in ``src/repro/launch/train_step.py``).

Each worker — one process of the data-parallel group, one device —

  grads  <- autograd over its batch
  alpha  <- Armijo search on the same batch             (Algorithm 3 l.4)
  gamma  <- the round's compression level (fixed schedule)
  update <- compress + all-gather the packed payload     (Algorithm 3 l.5-7)
  params <- params - update, unless the loss or the update is non-finite

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
    tree_sqnorm
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.core.error_feedback import init_ef
from repro_torch.core.gamma import gamma_init
from repro_torch.core.telemetry import CompressionTelemetry
from repro_torch.models import lm
from repro_torch.utils import tree_leaves, tree_map, value_and_grad

f32 = np.float32

METRIC_KEYS = ("loss", "grad_sqnorm", "alpha", "n_evals", "gamma",
               "wire_bytes", "ef_backlog", "ef_cosine")


@dataclasses.dataclass(frozen=True)
class TrainState:
    """One worker's optimizer state (the JAX ``DistOptState`` without its
    leading worker axis: each process holds its own)."""

    step: int
    alpha_prev: np.float32
    memory: dict                  # EF memory, f32 leaves like params
    n_evals_ema: np.float32
    gamma: np.float32
    telemetry: CompressionTelemetry
    cum_wire_bytes: np.float32
    steps_skipped: int


def init_train_state(params, run_cfg) -> TrainState:
    opt = run_cfg.optimizer
    device = tree_leaves(params)[0].device
    return TrainState(
        step=0, alpha_prev=f32(opt.armijo.alpha0),
        memory=init_ef(params),
        n_evals_ema=f32(0.0),
        gamma=gamma_init(opt.compressor),
        telemetry=CompressionTelemetry.init(device),
        cum_wire_bytes=f32(0.0), steps_skipped=0)


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
    gamma_t = state.gamma                 # the fixed schedule
    with record_function("train_step.exchange"):
        updates, new_mem, wire, tel = worker_compress_aggregate(
            grads, state.memory, res.eta, opt.compressor, group,
            stacked_mask=lm.stacked_mask(params))

    with record_function("train_step.metrics"):
        local = torch.stack(
            [loss.float(), gsq.float()]
            + [torch.tensor(float(x), device=loss.device)
               for x in (res.alpha, res.n_evals, gamma_t, wire)]
            + [tel.ef_backlog, tel.cosine])
        metrics = dict(zip(METRIC_KEYS,
                           all_reduce_mean(local, group).tolist()))
    cum_wire = state.cum_wire_bytes + f32(metrics["wire_bytes"])
    metrics["cum_wire_bytes"] = float(cum_wire)

    # the decoded aggregate is the same on every worker, so the gate
    # needs no collective beyond the loss mean above
    step_ok = bool(np.isfinite(metrics["loss"])) and bool(
        _all_finite(updates))
    skipped = state.steps_skipped + (0 if step_ok else 1)
    metrics["steps_skipped"] = float(skipped)
    if not step_ok:
        return params, dataclasses.replace(
            state, step=state.step + 1, cum_wire_bytes=cum_wire,
            steps_skipped=skipped), metrics
    new_params = tree_map(lambda p, u: (p.float() - u).to(p.dtype),
                          params, updates)
    return new_params, TrainState(
        step=state.step + 1, alpha_prev=res.alpha, memory=new_mem,
        n_evals_ema=f32(0.9) * state.n_evals_ema + f32(0.1) * f32(
            res.n_evals),
        gamma=gamma_t, telemetry=tel, cum_wire_bytes=cum_wire,
        steps_skipped=skipped), metrics
