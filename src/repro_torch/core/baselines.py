"""Baseline optimizers the paper compares against (twin of
``src/repro/core/baselines.py``, §IV).

* ``NonAdaptiveCSGD`` — top-k with memory feedback at a fixed step size
  (Aji & Heafield; the paper's main baseline).
* ``SGD``             — plain uncompressed SGD, optional heavy-ball
  momentum.
* ``SLS``             — uncompressed SGD with the Armijo line search
  (Vaswani et al.; the method CSGD-ASSS extends to compression).

All share CSGD's ``init`` / ``step(loss_fn, params, state)`` interface.
Every ``a*x + y`` is one rounding (``addcmul`` / ``add(alpha=)``), as the
JAX package's jitted FMA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten, value_and_grad
from .armijo import ArmijoConfig, armijo_search, next_alpha_max, tree_sqnorm
from .compression import Compressor
from .error_feedback import init_ef

f32 = np.float32


class NonAdaptiveState(NamedTuple):
    step: int
    memory: Any


class NonAdaptiveAux(NamedTuple):
    loss: torch.Tensor
    grad_sqnorm: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NonAdaptiveCSGD:
    """Compressed SGD with memory feedback, fixed step size eta."""

    eta: float = 0.1
    compressor: Compressor = Compressor()

    def init(self, params) -> NonAdaptiveState:
        return NonAdaptiveState(step=0, memory=init_ef(params))

    def step(self, loss_fn: Callable, params, state: NonAdaptiveState):
        loss, grads = value_and_grad(loss_fn, params)
        flat_m, structure = tree_flatten(state.memory)
        sent, resid = [], []
        with torch.no_grad():
            for m, g in zip(flat_m, tree_leaves(grads)):
                eta = torch.tensor(self.eta, dtype=m.dtype, device=m.device)
                s, r = self.compressor.compress_dense(
                    torch.addcmul(m, eta, g.to(m.dtype)))
                sent.append(s)
                resid.append(r)
            new_params = tree_map(lambda p, s: (p.float() - s).to(p.dtype),
                                  params, tree_unflatten(structure, sent))
        return new_params, NonAdaptiveState(
            state.step + 1, tree_unflatten(structure, resid)), \
            NonAdaptiveAux(loss=loss, grad_sqnorm=tree_sqnorm(grads))


class SGDState(NamedTuple):
    step: int
    momentum: Any


@dataclasses.dataclass(frozen=True)
class SGD:
    """Plain (uncompressed) SGD, optional heavy-ball momentum."""

    eta: float = 0.1
    beta: float = 0.0

    def init(self, params) -> SGDState:
        mom = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
               if self.beta else None)
        return SGDState(step=0, momentum=mom)

    def step(self, loss_fn: Callable, params, state: SGDState):
        loss, grads = value_and_grad(loss_fn, params)
        with torch.no_grad():
            if self.beta:
                beta = torch.tensor(self.beta, dtype=torch.float32,
                                    device=loss.device)
                mom = tree_map(lambda v, g: torch.addcmul(g.float(), beta, v),
                               state.momentum, grads)
                upd = mom
            else:
                mom, upd = None, grads
            new_params = tree_map(
                lambda p, u: torch.add(p.float(), u.float(),
                                       alpha=-self.eta).to(p.dtype),
                params, upd)
        return new_params, SGDState(state.step + 1, mom), \
            NonAdaptiveAux(loss=loss, grad_sqnorm=tree_sqnorm(grads))


class SLSState(NamedTuple):
    step: int
    alpha_prev: np.float32


class SLSAux(NamedTuple):
    loss: torch.Tensor
    alpha: np.float32
    n_evals: int


@dataclasses.dataclass(frozen=True)
class SLS:
    """Uncompressed stochastic line search (no scaling, no compression)."""

    armijo: ArmijoConfig = ArmijoConfig(a_scale=1.0)

    def init(self, params) -> SLSState:
        return SLSState(step=0, alpha_prev=f32(self.armijo.alpha0))

    def step(self, loss_fn: Callable, params, state: SLSState):
        loss, grads = value_and_grad(loss_fn, params)
        gsq = tree_sqnorm(grads)
        res = armijo_search(loss_fn, params, grads,
                            next_alpha_max(state.alpha_prev, self.armijo),
                            self.armijo, f0=loss, grad_sqnorm=gsq)
        eta = float(f32(self.armijo.a_scale) * res.alpha)
        with torch.no_grad():
            new_params = tree_map(
                lambda p, g: torch.add(p.float(), g.float(),
                                       alpha=-eta).to(p.dtype),
                params, grads)
        return new_params, SLSState(state.step + 1, res.alpha), \
            SLSAux(loss=loss, alpha=res.alpha, n_evals=res.n_evals)
