"""Armijo step-size search with scaling (twin of ``src/repro/core/armijo.py``,
paper Algorithm 1 + §III-A).

* The search tests ``alpha_max`` first and then backtracks by ``rho``
  (the do-while reading of Algorithm 1, DESIGN.md §7).
* Stopping condition (2): ``f(x - alpha*grad) <= f(x) -
  sigma*alpha*||grad||^2``, with the unscaled alpha; a non-finite trial
  loss is a reject.
* The descent step is ``eta = a * alpha``; with ``theory_safe`` the
  caller takes ``a = scale_for(gamma_t)``, clamped to the round's bound.
* Across iterations ``alpha_max_t = omega * alpha_{t-1}``.

PyTorch runs eagerly, so the loop is a host loop: each trial reads its
loss back (one sync per trial, where the JAX package runs a device while
loop).  The scalar arithmetic is float32 throughout, as in the JAX
package, so the accept/reject decisions agree on the same losses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class ArmijoConfig:
    sigma: float = 0.1          # sufficient-decrease parameter
    rho: float = 0.8            # backtracking factor
    omega: float = 1.2          # alpha_max growth
    a_scale: float = 0.3        # eta = a * alpha (paper: a = 3*sigma)
    alpha0: float = 0.1         # initial alpha_max
    max_backtracks: int = 40
    alpha_min: float = 1e-8
    #: clamp the step scale to the compressed-SGD bound zeta(gamma_t)
    #: each round (off by default: the paper runs a = 3*sigma)
    theory_safe: bool = False

    def zeta(self, gamma) -> np.float32:
        """The compressed-SGD bound a <= sigma*gamma/(2-gamma), in f32."""
        g = f32(gamma)
        return f32(self.sigma) * g / (f32(2.0) - g)

    def scale_for(self, gamma=None) -> np.float32:
        """The step scale a of a round at compression level ``gamma``:
        ``a_scale``, clamped to ``zeta(gamma)`` under ``theory_safe``."""
        if gamma is None or not self.theory_safe:
            return f32(self.a_scale)
        return min(f32(self.a_scale), self.zeta(gamma))


class ArmijoResult(NamedTuple):
    alpha: np.float32     # accepted (unscaled) alpha_t
    eta: np.float32       # a * alpha_t
    f0: np.float32        # f(x_t) on the sampled batch
    n_evals: int          # stopping-condition evaluations
    accepted: bool        # condition met before the caps


def tree_sqnorm(tree) -> torch.Tensor:
    """sum of squares over every leaf, as one f32 0-dim tensor."""
    total = None
    for leaf in tree_leaves(tree):
        s = leaf.float().square().sum()
        total = s if total is None else total + s
    return total


def _candidate(p: torch.Tensor, g: torch.Tensor, a: float) -> torch.Tensor:
    """JAX's ``y - a * x.astype(y.dtype)`` with an f32 ``a``: a bf16 leaf
    is promoted, so the candidate is f32 (its users cast it as they cast
    the parameter); an f32 leaf stays f32."""
    g = g.to(p.dtype)
    if p.dtype != torch.float32:
        p, g = p.float(), g.float()
    return torch.add(p, g, alpha=-a)


def armijo_search(loss_fn: Callable, params, grads, alpha_max,
                  cfg: ArmijoConfig, f0=None,
                  grad_sqnorm=None) -> ArmijoResult:
    """Run Algorithm 1 from ``alpha_max`` on the sampled batch's loss
    ``loss_fn`` (called under ``torch.no_grad``)."""
    with torch.no_grad():
        if f0 is None:
            f0 = loss_fn(params)
        if grad_sqnorm is None:
            grad_sqnorm = tree_sqnorm(grads)
        f0 = f32(float(f0))
        gsq = f32(float(grad_sqnorm))
        sigma = f32(cfg.sigma)

        def trial(alpha):
            a = float(alpha)
            cand = tree_map(lambda p, g: _candidate(p, g, a), params, grads)
            return f32(float(loss_fn(cand)))

        def ok(f_try, alpha):
            return bool(np.isfinite(f_try)) and \
                bool(f_try <= f0 - sigma * alpha * gsq)

        alpha = f32(alpha_max)
        f_try = trial(alpha)
        n = 1
        while not ok(f_try, alpha) and n < cfg.max_backtracks \
                and alpha > f32(cfg.alpha_min):
            alpha = alpha * f32(cfg.rho)
            f_try = trial(alpha)
            n += 1
        accepted = ok(f_try, alpha)
    return ArmijoResult(alpha=alpha, eta=f32(cfg.a_scale) * alpha,
                        f0=f0, n_evals=n, accepted=accepted)


def next_alpha_max(alpha_t, cfg: ArmijoConfig) -> np.float32:
    """Algorithm 2 step 3: alpha_max_{t+1} = omega * alpha_t."""
    return f32(np.clip(f32(cfg.omega) * f32(alpha_t), f32(cfg.alpha_min),
                       f32(1e6)))


def next_evals_ema(ema, n_evals) -> np.float32:
    """The running mean 0.9 * ema + 0.1 * n_evals as the jitted JAX
    package computes it: XLA contracts the multiply-add into one f32
    rounding (the product of two f32 is exact in a double)."""
    return f32(float(f32(0.9)) * float(f32(ema))
               + float(f32(0.1) * f32(n_evals)))


def reciprocal_product(x, n) -> np.float32:
    """``x / n`` for a constant ``n`` as jitted XLA computes it: a product
    with f32(1/n), which differs from a division in the last bit (at n 3
    for a third of integer-valued x; at n 1.2, ``alpha_max / omega``, for
    a quarter of values)."""
    return f32(f32(x) * (f32(1.0) / f32(n)))


def local_evals_ema(ema, evals, local_steps: int) -> np.float32:
    """The local-steps round's running mean ``0.9 * ema + 0.1 * evals /
    H`` as jitted XLA computes it in JAX's worker, where the breaker's
    select takes the result: the constants fold into c = f32(0.1) *
    f32(1/H), ``0.9 * ema`` rounds, and ``evals * c`` is added to it in
    one fused multiply-add.  (Without the select XLA fuses the other
    product instead; the breaker is on by default.)"""
    c = f32(0.1) * (f32(1.0) / f32(local_steps))
    return f32(float(f32(evals)) * float(c)
               + float(f32(0.9) * f32(ema)))
