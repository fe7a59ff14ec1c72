"""CSGD-ASSS — Compressed SGD with Armijo Step-Size Search and Scaling
(twin of ``src/repro/core/csgd.py``, paper Algorithm 2, single process).

    opt = csgd_asss(CSGDConfig(...))
    state = opt.init(params)
    params, state, aux = opt.step(loss_fn, params, state)

``loss_fn(params) -> scalar tensor`` is the sampled batch's loss
``f_{i_t}``; params is a tensor or a tree of nested dicts/lists of
tensors.  Each step: autograd, the Armijo search from
``alpha_max = omega * alpha_{t-1}``, ``eta = a * alpha``, then per leaf
``acc = m + eta*g`` (one rounding, as the JAX package's jitted FMA),
``(sent, m') = compress_dense(acc)`` over the whole flattened leaf, and
``params -= sent``.  With ``block_topk`` every compressed leaf launches
the ``block_stats`` and ``threshold_split`` kernels once per step.  Each
step first runs a round of the gamma controller (``core/gamma.py``) and
takes ``eta = scale_for(gamma_t) * alpha``; an adaptive compressor then
compresses at gamma_t through its plain ragged path, as the JAX
package's does (no kernel).

Host scalars (alpha, eta, gamma, byte counts) are numpy float32, as the
port's Armijo search is a host loop; tensors stay on the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten, value_and_grad
from .armijo import ArmijoConfig, armijo_search, next_alpha_max, \
    next_evals_ema, tree_sqnorm
from .compression import Compressor, tree_effective_wire_bytes, \
    tree_wire_bytes
from .error_feedback import QuantizedEF, dequantize_ef, init_ef, \
    init_ef_quantized, quantize_ef
from .gamma import GammaControllerConfig, gamma_init, gamma_update
from .telemetry import CompressionTelemetry, SearchTelemetry, TelemetrySums

f32 = np.float32
EF_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class CSGDConfig:
    #: None = no line search: the fixed-step compressed baseline, with
    #: ``eta`` below as the step size (cf. NonAdaptiveCSGD).
    armijo: ArmijoConfig | None = ArmijoConfig()
    compressor: Compressor = Compressor()
    #: per-round compression-level controller (core/gamma.py)
    gamma_ctrl: GammaControllerConfig = GammaControllerConfig()
    eta: float = 0.1                # fixed step when armijo is None
    ef_dtype: str = "float32"       # float32 | bfloat16 | int8
    use_scaling: bool = True        # False reproduces the divergent variant
    #: heavy-ball velocity accumulated before compression (EF-SGDm)
    momentum: float = 0.0

    def __post_init__(self):
        if self.ef_dtype not in EF_DTYPES:
            raise ValueError(f"ef_dtype {self.ef_dtype!r} not in "
                             f"{EF_DTYPES}")
        if self.armijo is None and \
                self.gamma_ctrl.schedule == "armijo-coupled":
            raise ValueError("armijo-coupled gamma schedule needs the "
                             "Armijo search (armijo=None)")


class CSGDState(NamedTuple):
    step: int
    alpha_prev: np.float32    # alpha_{t-1}
    memory: Any               # EF m_t shaped like params (or QuantizedEF)
    n_evals_ema: np.float32   # running mean of Armijo evaluations
    gamma: np.float32         # the round's compression level gamma_t
    telemetry: CompressionTelemetry
    cum_eff_bytes: np.float32  # run total of effective wire bytes
    velocity: Any = ()        # heavy-ball state (momentum > 0 only)


class StepAux(NamedTuple):
    loss: torch.Tensor
    alpha: np.float32
    eta: np.float32
    n_evals: int
    grad_sqnorm: torch.Tensor
    accepted: bool
    gamma: np.float32
    wire_bytes: np.float32        # payload bytes a worker would ship
    eff_wire_bytes: np.float32    # the same at gamma_t's valid entries
    telemetry: CompressionTelemetry
    cum_eff_bytes: np.float32


def _ef_to_dense(memory):
    def leaf(m):
        if isinstance(m, QuantizedEF):
            return dequantize_ef(m)
        return m.float()
    return tree_map(leaf, memory)


def _ef_from_dense(memory_dense, ef_dtype: str):
    if ef_dtype == "int8":
        return tree_map(quantize_ef, memory_dense)
    return tree_map(lambda m: m.to(getattr(torch, ef_dtype)), memory_dense)


class CSGD:
    """Algorithm 2; also the non-adaptive baseline via ``armijo=None``."""

    def __init__(self, cfg: CSGDConfig):
        self.cfg = cfg

    def init(self, params) -> CSGDState:
        cfg = self.cfg
        if cfg.ef_dtype == "int8":
            memory = init_ef_quantized(params)
        else:
            memory = init_ef(params, getattr(torch, cfg.ef_dtype))
        vel = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
               if cfg.momentum else ())
        alpha0 = cfg.armijo.alpha0 if cfg.armijo is not None else cfg.eta
        return CSGDState(
            step=0, alpha_prev=f32(alpha0), memory=memory,
            n_evals_ema=f32(0.0),
            gamma=gamma_init(cfg.gamma_ctrl, cfg.compressor),
            telemetry=CompressionTelemetry.init(tree_leaves(params)[0].device),
            cum_eff_bytes=f32(0.0), velocity=vel)

    def step(self, loss_fn: Callable, params, state: CSGDState):
        cfg = self.cfg
        comp = cfg.compressor
        loss, grads = value_and_grad(loss_fn, params)
        gsq = tree_sqnorm(grads)
        device = loss.device

        # --- Armijo search with alpha_max = omega * alpha_{t-1} (step 3)
        if cfg.armijo is not None:
            res = armijo_search(loss_fn, params, grads,
                                next_alpha_max(state.alpha_prev, cfg.armijo),
                                cfg.armijo, f0=loss, grad_sqnorm=gsq)
            alpha, n_evals, accepted = res.alpha, res.n_evals, res.accepted
        else:
            alpha, n_evals, accepted = f32(cfg.eta), 0, True

        # --- the round's compression level (controller round, step t)
        gamma_t = gamma_update(
            cfg.gamma_ctrl, comp, state.gamma, state.step,
            search=SearchTelemetry(alpha=alpha, alpha_prev=state.alpha_prev,
                                   n_evals=f32(n_evals),
                                   n_evals_ema=state.n_evals_ema),
            compression=state.telemetry)
        if cfg.armijo is not None and cfg.use_scaling:
            eta = cfg.armijo.scale_for(gamma_t) * alpha
        else:
            eta = alpha                 # a = 1: the divergent variant

        # --- heavy-ball velocity, before compression
        if cfg.momentum:
            mom = torch.tensor(cfg.momentum, dtype=torch.float32,
                               device=device)
            vel = tree_map(lambda v, g: torch.addcmul(g.float(), mom, v),
                           state.velocity, grads)
            descent = vel
        else:
            vel = state.velocity
            descent = grads

        # --- compressed descent with error feedback (steps 6-8)
        eta_t = torch.tensor(eta, dtype=torch.float32, device=device)
        flat_m, structure = tree_flatten(_ef_to_dense(state.memory))
        sums = TelemetrySums.zero(device)
        sent, resid = [], []
        with torch.no_grad():
            for m, g in zip(flat_m, tree_leaves(descent)):
                gf = g.to(m.dtype)
                acc = torch.addcmul(m, eta_t, gf)
                s, r = comp.compress_dense(acc, gamma_t)
                # single-node semantics: decode(own) IS the dense `sent`
                sums = sums.add(g_sq=(gf * gf).sum(), acc_sq=(acc * acc).sum(),
                                resid_sq=(r * r).sum(), own_sq=(s * s).sum(),
                                own_dot_g=(s * gf).sum())
                sent.append(s)
                resid.append(r)
            new_params = tree_map(lambda p, s: (p.float() - s).to(p.dtype),
                                  params, tree_unflatten(structure, sent))
        telemetry = sums.finalize()
        wire = f32(tree_wire_bytes(params, comp))
        eff = tree_effective_wire_bytes(params, comp, gamma_t) \
            if comp.adaptive else wire
        cum_eff = f32(state.cum_eff_bytes + eff)
        new_state = CSGDState(
            step=state.step + 1, alpha_prev=alpha,
            memory=_ef_from_dense(tree_unflatten(structure, resid),
                                  cfg.ef_dtype),
            n_evals_ema=next_evals_ema(state.n_evals_ema, n_evals),
            gamma=gamma_t, telemetry=telemetry, cum_eff_bytes=cum_eff,
            velocity=vel)
        aux = StepAux(loss=loss, alpha=alpha, eta=eta, n_evals=n_evals,
                      grad_sqnorm=gsq, accepted=accepted, gamma=gamma_t,
                      wire_bytes=wire, eff_wire_bytes=eff,
                      telemetry=telemetry, cum_eff_bytes=cum_eff)
        return new_params, new_state, aux


def csgd_asss(cfg: CSGDConfig | None = None) -> CSGD:
    return CSGD(cfg or CSGDConfig())
