"""ACGD — accelerated (Nesterov-momentum) compressed gradient descent
(twin of ``src/repro/core/acgd.py``; Li, Kovalev, Qian, Richtárik,
arXiv 2002.11364, composed with error feedback).

    opt = acgd(AcgdConfig(...))
    state = opt.init(params)
    params, state, aux = opt.step(loss_fn, params, state)

Each step, per leaf::

    v   = mu * v + g          (momentum buffer, f32)
    d   = mu * v + g          (Nesterov lookahead, from the new v)
    acc = m + eta * d         (EF accumulator)
    sent, m' = compress(acc), acc - sent
    x   = x - sent

Each of the three lines rounds once, as jitted XLA contracts each into
a fused multiply-add (``torch.addcmul``).  There is no Armijo search:
the step is the fixed ``eta``; the gamma controller still sets the
round's compression level (``fixed``, ``linear``, ``ef-coupled``).  The
telemetry sums take the raw gradient g (``g_sq`` and ``own_dot_g``)
while acc is built from d — unlike the trainer's ``kind="acgd"``, whose
exchange sees d as its gradient.  With ``block_topk`` every compressed
leaf launches the ``block_stats`` and ``threshold_split`` kernels once
a step, as single-node CSGD does.

Host scalars (eta, gamma, byte counts) are numpy float32; tensors stay
on the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten, value_and_grad
from .armijo import tree_sqnorm
from .compression import Compressor, tree_effective_wire_bytes, \
    tree_wire_bytes
from .gamma import GammaControllerConfig, gamma_init, gamma_update
from .telemetry import CompressionTelemetry, TelemetrySums

f32 = np.float32
#: EF memory dtypes (JAX's int8 would truncate every |residual| < 1)
EF_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class AcgdConfig:
    compressor: Compressor = Compressor()
    gamma_ctrl: GammaControllerConfig = GammaControllerConfig()
    eta: float = 0.1                # fixed step size
    momentum: float = 0.9           # Nesterov mu
    ef_dtype: str = "float32"

    def __post_init__(self):
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got "
                             f"{self.momentum}")
        if self.gamma_ctrl.schedule == "armijo-coupled":
            raise ValueError("acgd has no Armijo search for the "
                             "armijo-coupled gamma schedule to couple to "
                             "— use fixed | linear | ef-coupled")
        if self.ef_dtype not in EF_DTYPES:
            raise ValueError(f"ef_dtype {self.ef_dtype!r} not in "
                             f"{EF_DTYPES}")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class AcgdState(NamedTuple):
    step: int
    memory: Any               # EF m_t shaped like params, in ef_dtype
    velocity: Any             # Nesterov buffer v_t, f32
    gamma: np.float32         # the round's compression level gamma_t
    telemetry: CompressionTelemetry
    cum_eff_bytes: np.float32  # run total of effective wire bytes


class AcgdAux(NamedTuple):
    loss: torch.Tensor
    eta: np.float32
    grad_sqnorm: torch.Tensor
    gamma: np.float32
    wire_bytes: np.float32
    eff_wire_bytes: np.float32
    telemetry: CompressionTelemetry
    cum_eff_bytes: np.float32


def nesterov(velocity, grads, momentum: float):
    """``(v', d)``: ``v' = mu·v + g`` and ``d = mu·v' + g`` leaf by leaf,
    in f32, each rounded once (``torch.addcmul``), as jitted XLA contracts
    both lines of JAX's ``ACGD.step`` and of the trainer's ``worker_fn``
    into fused multiply-adds."""
    mu = torch.tensor(momentum, dtype=torch.float32,
                      device=tree_leaves(grads)[0].device)
    with torch.no_grad():
        vel = tree_map(lambda v, g: torch.addcmul(g.float(), mu, v),
                       velocity, grads)
        return vel, tree_map(lambda v, g: torch.addcmul(g.float(), mu, v),
                             vel, grads)


def _zeros(params, dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


class ACGD:
    """Single-node ACGD (arXiv 2002.11364 composed with EF)."""

    def __init__(self, cfg: AcgdConfig):
        self.cfg = cfg

    def init(self, params) -> AcgdState:
        cfg = self.cfg
        return AcgdState(
            step=0, memory=_zeros(params, getattr(torch, cfg.ef_dtype)),
            velocity=_zeros(params, torch.float32),
            gamma=gamma_init(cfg.gamma_ctrl, cfg.compressor),
            telemetry=CompressionTelemetry.init(tree_leaves(params)[0].device),
            cum_eff_bytes=f32(0.0))

    def step(self, loss_fn: Callable, params, state: AcgdState):
        cfg = self.cfg
        comp = cfg.compressor
        loss, grads = value_and_grad(loss_fn, params)
        gsq = tree_sqnorm(grads)
        device = loss.device

        gamma_t = gamma_update(cfg.gamma_ctrl, comp, state.gamma,
                               state.step, compression=state.telemetry)
        eta = f32(cfg.eta)
        eta_t = torch.tensor(eta, dtype=torch.float32, device=device)
        vel, descent = nesterov(state.velocity, grads, cfg.momentum)
        with torch.no_grad():
            flat_m, structure = tree_flatten(state.memory)
            sums = TelemetrySums.zero(device)
            sent, resid = [], []
            for m, d, g in zip(flat_m, tree_leaves(descent),
                               tree_leaves(grads)):
                gf = g.float()
                acc = torch.addcmul(m.float(), eta_t, d)
                s, r = comp.compress_dense(
                    acc, gamma_t if comp.adaptive else None)
                sums = sums.add(g_sq=(gf * gf).sum(), acc_sq=(acc * acc).sum(),
                                resid_sq=(r * r).sum(), own_sq=(s * s).sum(),
                                own_dot_g=(s * gf).sum())
                sent.append(s)
                resid.append(r.to(m.dtype))
            del descent
            new_params = tree_map(lambda p, s: (p.float() - s).to(p.dtype),
                                  params, tree_unflatten(structure, sent))
        telemetry = sums.finalize()
        wire = f32(tree_wire_bytes(params, comp))
        eff = tree_effective_wire_bytes(params, comp, gamma_t) \
            if comp.adaptive else wire
        cum_eff = f32(state.cum_eff_bytes + eff)
        new_state = AcgdState(
            step=state.step + 1, memory=tree_unflatten(structure, resid),
            velocity=vel, gamma=gamma_t, telemetry=telemetry,
            cum_eff_bytes=cum_eff)
        aux = AcgdAux(loss=loss, eta=eta, grad_sqnorm=gsq, gamma=gamma_t,
                      wire_bytes=wire, eff_wire_bytes=eff,
                      telemetry=telemetry, cum_eff_bytes=cum_eff)
        return new_params, new_state, aux


def acgd(cfg: AcgdConfig | None = None) -> ACGD:
    return ACGD(cfg or AcgdConfig())
