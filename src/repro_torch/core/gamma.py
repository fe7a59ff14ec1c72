"""Per-round compression level (twin of ``src/repro/core/gamma.py``).

A controller is a pure function of the previous gamma_t and the typed
telemetry of the round that just finished.  Schedules:

* ``fixed``          — gamma_t = gamma0 (the paper's setting);
* ``linear``         — gamma0 to gamma_max over ``ramp_steps`` steps;
* ``armijo-coupled`` — grow when the line search struggles (``n_evals``
                       running mean above ``evals_hi``, or alpha collapsed
                       below ``alpha_collapse`` of the previous round's),
                       shrink when it accepts at once;
* ``ef-coupled``     — hold the EF backlog ``||m'||/||g||`` inside
                       ``ef_target +- ef_band``: grow above it (or when it
                       is not finite), shrink below it while the decode
                       cosine is at least ``cos_floor``.

gamma_t stays in ``[gamma_min, gamma_max]``, and gamma_max never exceeds
the compressor's static budget (``Compressor.geometry_gamma``).

The port runs the controller on the host: gamma_t is a numpy float32, and
each value equals the jitted JAX package's bit for bit.  XLA computes the
linear ramp's ``step / ramp_steps`` as a multiplication by the f32
reciprocal of the constant and fuses ``g0 + (gmax - g0) * frac`` into one
rounding; :func:`gamma_update` does the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .telemetry import CompressionTelemetry, SearchTelemetry

f32 = np.float32
SCHEDULES = ("fixed", "linear", "armijo-coupled", "ef-coupled")


@dataclasses.dataclass(frozen=True)
class GammaControllerConfig:
    """Zeros mean "derive from the compressor": gamma0 defaults to
    ``Compressor.gamma``, gamma_max to its budget (``geometry_gamma``),
    gamma_min to ``gamma0 / 8``."""

    schedule: str = "fixed"       # fixed | linear | armijo- | ef-coupled
    gamma0: float = 0.0
    gamma_min: float = 0.0
    gamma_max: float = 0.0
    ramp_steps: int = 1000        # linear: steps from gamma0 to gamma_max
    grow: float = 1.5             # coupled: multiplicative grow
    shrink: float = 0.9           # coupled: multiplicative shrink
    evals_hi: float = 3.0         # armijo: grow when n_evals_ema above
    evals_lo: float = 2.0         # armijo: shrink allowed only below
    alpha_collapse: float = 0.5   # armijo: grow when alpha < c*alpha_prev
    ef_target: float = 0.15       # ef: backlog the band centres on
    ef_band: float = 0.08         # ef: grow above target+band, shrink
                                  # below target-band
    cos_floor: float = 0.0        # ef: shrink only while cosine >= this

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown gamma schedule {self.schedule!r} "
                             f"(want one of {SCHEDULES})")
        if self.schedule == "ef-coupled" and self.ef_band >= self.ef_target:
            raise ValueError(
                f"ef-coupled hysteresis band must sit above zero backlog: "
                f"ef_band={self.ef_band} >= ef_target={self.ef_target} "
                f"would make the shrink threshold non-positive")

    def resolve(self, comp) -> tuple[float, float, float]:
        """(gamma0, gamma_min, gamma_max) with the compressor's defaults
        filled in; gamma_max is clipped to the compressor's budget."""
        budget = comp.geometry_gamma
        g0 = self.gamma0 or comp.gamma
        gmax = min(self.gamma_max or budget, budget)
        gmin = self.gamma_min or g0 / 8.0
        if gmin > gmax:
            raise ValueError(
                f"gamma_min={gmin} exceeds the resolved gamma_max={gmax} "
                f"(compressor budget {budget}): the controller band is "
                f"inverted and the clip would pin gamma to gamma_max — "
                f"lower gamma_min or raise the compressor's "
                f"gamma/max_gamma budget")
        g0 = min(max(g0, gmin), gmax)
        return g0, gmin, gmax


def gamma_init(cfg: GammaControllerConfig, comp) -> np.float32:
    """Initial gamma_t for the optimizer state."""
    return f32(cfg.resolve(comp)[0])


def _clip(x, lo: float, hi: float) -> np.float32:
    """``jnp.clip(x, lo, hi)`` with the bounds rounded to f32."""
    return f32(min(max(f32(x), f32(lo)), f32(hi)))


def _host(x) -> np.float32:
    """A telemetry value (host scalar or 0-dim tensor) as a float32."""
    return f32(float(x))


def gamma_update(cfg: GammaControllerConfig, comp, gamma, step: int, *,
                 search: SearchTelemetry | None = None,
                 compression: CompressionTelemetry | None = None
                 ) -> np.float32:
    """One controller round: gamma_t from gamma_{t-1} and the telemetry of
    the round that just finished (``search`` for ``armijo-coupled``,
    ``compression`` for ``ef-coupled``)."""
    g0, gmin, gmax = cfg.resolve(comp)
    if cfg.schedule == "fixed":
        return f32(g0)
    if cfg.schedule == "linear":
        rcp = f32(1.0) / f32(max(cfg.ramp_steps, 1))
        frac = min(max(f32(step) * rcp, f32(0.0)), f32(1.0))
        # one rounding of the fused multiply-add: the product of two f32
        # is exact in a double
        g = f32(float(f32(gmax - g0)) * float(frac) + float(f32(g0)))
        return _clip(g, gmin, gmax)

    if cfg.schedule == "ef-coupled":
        if compression is None:
            raise ValueError("ef-coupled schedule needs the round's "
                             "CompressionTelemetry")
        backlog = _host(compression.ef_backlog)
        cosine = _host(compression.cosine)
        over = bool(backlog > f32(cfg.ef_target + cfg.ef_band)) \
            or not np.isfinite(backlog)
        slack = bool(backlog < f32(cfg.ef_target - cfg.ef_band)) \
            and bool(cosine >= f32(cfg.cos_floor))
        factor = cfg.grow if over else cfg.shrink if slack else 1.0
        return _clip(f32(gamma) * f32(factor), gmin, gmax)

    if search is None:
        raise ValueError("armijo-coupled schedule needs the round's "
                         "SearchTelemetry")
    alpha, alpha_prev = _host(search.alpha), _host(search.alpha_prev)
    ema, nev = _host(search.n_evals_ema), _host(search.n_evals)
    struggling = bool(ema > f32(cfg.evals_hi)) or bool(
        alpha < f32(cfg.alpha_collapse) * alpha_prev)
    instant = bool(nev <= f32(1.0)) and bool(ema < f32(cfg.evals_lo))
    factor = cfg.grow if struggling else cfg.shrink if instant else 1.0
    return _clip(f32(gamma) * f32(factor), gmin, gmax)
