"""Step-level health state and the divergence circuit breaker (twin of
``src/repro/core/health.py``).

A round whose group-mean loss or decoded update is non-finite is
SKIPPED: the parameters and every carried optimizer quantity stay as
they were, while the step counter, the byte counters and these counters
advance.  ``OptimizerConfig.max_consecutive_skips`` consecutive skips
raise :class:`DivergenceError` on the host, naming the last step that
wrote parameters so a rollback knows where to aim.

The port's optimizer state lives on the host (``TrainState``), so the
counters are host ints and a host float32, where the JAX package keeps
(W,)-shaped device arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import tree_leaves


class DivergenceError(RuntimeError):
    """Raised (host-side) when the consecutive-skip threshold trips."""

    def __init__(self, step: int, last_good_step: int,
                 consecutive: int, threshold: int):
        self.step = int(step)
        self.last_good_step = int(last_good_step)
        self.consecutive = int(consecutive)
        self.threshold = int(threshold)
        super().__init__(
            f"divergence at step {self.step}: {self.consecutive} "
            f"consecutive non-finite steps skipped (threshold "
            f"{self.threshold}); last good step was "
            f"{self.last_good_step} — roll back to a checkpoint at or "
            f"before it")


@dataclasses.dataclass(frozen=True)
class HealthState:
    """One worker's step-health counters (``TrainState.health``)."""

    steps_skipped: int = 0        # total gated-off steps
    consecutive_skips: int = 0    # current skip run length
    last_good_step: int = -1      # last step that wrote params (-1 before
                                  # the first good step)
    rows_quarantined: np.float32 = np.float32(0.0)  # cumulative rows the
                                  # faulty transport's verdicts dropped


def all_finite(*trees) -> torch.Tensor:
    """0-dim bool tensor: every leaf of every tree is all-finite, on the
    leaves' device (one reduction chain, no collective)."""
    ok = None
    for t in trees:
        for leaf in tree_leaves(t):
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else ok & f
    return ok if ok is not None else torch.tensor(True)


def advance_health(health: HealthState, step_ok: bool, step: int,
                   quarantined) -> HealthState:
    """Next round's counters given this round's gate verdict.

    ``step_ok``: True when the round wrote parameters; ``step``: the
    index of the round that just ran; ``quarantined``: this round's
    quarantined row count.
    """
    return HealthState(
        steps_skipped=health.steps_skipped + (0 if step_ok else 1),
        consecutive_skips=0 if step_ok else health.consecutive_skips + 1,
        last_good_step=int(step) if step_ok else health.last_good_step,
        rows_quarantined=np.float32(health.rows_quarantined
                                    + np.float32(quarantined)))


def check_divergence(metrics, max_consecutive_skips: int) -> None:
    """Host-side breaker: raise :class:`DivergenceError` when a metrics
    dict (one step: ``consecutive_skips``, ``last_good_step``, ``step``)
    shows the threshold tripped.  A no-op when the breaker is disabled
    (``max_consecutive_skips <= 0``) or the keys are absent."""
    if max_consecutive_skips <= 0:
        return
    consec = metrics.get("consecutive_skips")
    if consec is None:
        return
    consec = int(consec)
    if consec >= max_consecutive_skips:
        raise DivergenceError(
            step=int(metrics.get("step", -1)),
            last_good_step=int(metrics.get("last_good_step", -1)),
            consecutive=consec,
            threshold=max_consecutive_skips)
