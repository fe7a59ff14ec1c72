"""Per-round client participation sampling (twin of
``src/repro/fed/sampling.py``, DESIGN.md §13; NumPy only, so every mask
is the JAX package's bit for bit).

Masks are built on the host with numpy, like the data pipelines in
``repro_torch.data.synthetic``: every mask is a pure function of
``(seed, round_idx)`` through a ``np.random.SeedSequence``, so every
process derives the identical mask without coordination and restarts
reproduce the same participation history from the step counter alone.
The mask enters the train step beside the batch, the same on every
worker: the cohort exchange never needs a collective to agree on who
participated.

Two samplers (``SAMPLERS``):

* ``fixed``     — exactly ``clients_per_round`` distinct clients,
  uniformly without replacement (the classic FedAvg sampler).
* ``bernoulli`` — each client participates independently with
  probability ``rate`` (partial-participation analyses, e.g.
  arXiv 2002.11364 §4).

``straggler_rate`` then drops each *selected* client independently —
the sampled-but-never-reported straggler model.  A round that ends with
zero participants raises :class:`ZeroParticipationError` instead of
letting a 0/0 aggregate turn into silent NaN updates downstream.
"""
from __future__ import annotations

import numpy as np

SAMPLERS = ("fixed", "bernoulli")

# SeedSequence domain tags: keep the sampling stream independent of the
# data streams (which key on [seed, step, shard]) and of each other.
_SAMPLE_TAG = 0x5ED5_A3B1
_STRAGGLER_TAG = 0x57A6_6E12


class ZeroParticipationError(ValueError):
    """No client survived sampling + straggler dropout this round."""


def validate_sampler(mode: str) -> None:
    if mode not in SAMPLERS:
        raise ValueError(f"unknown client sampler {mode!r} "
                         f"(want one of {SAMPLERS})")


def participation_mask(n_clients: int, round_idx: int, *, seed: int = 0,
                       mode: str = "fixed", clients_per_round: int = 0,
                       rate: float = 1.0,
                       straggler_rate: float = 0.0) -> np.ndarray:
    """The (n_clients,) float32 0/1 participation mask for one round.

    Deterministic in ``(seed, round_idx)`` and every config argument;
    independent of process, device count, or call order.  ``fixed`` mode
    selects exactly ``clients_per_round`` clients (0 -> all); bernoulli
    mode selects each with probability ``rate``.  Raises
    :class:`ZeroParticipationError` when nobody participates.
    """
    validate_sampler(mode)
    if n_clients <= 0:
        raise ValueError(f"n_clients must be positive, got {n_clients}")
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, round_idx, _SAMPLE_TAG]))
    mask = np.zeros((n_clients,), np.float32)
    if mode == "fixed":
        k = clients_per_round or n_clients
        if not 0 < k <= n_clients:
            raise ValueError(
                f"clients_per_round={clients_per_round} out of range "
                f"for n_clients={n_clients}")
        mask[rng.choice(n_clients, size=k, replace=False)] = 1.0
    else:  # bernoulli
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"participation rate must be in [0, 1], "
                             f"got {rate}")
        mask[rng.random(n_clients) < rate] = 1.0
    if straggler_rate:
        if not 0.0 <= straggler_rate < 1.0:
            raise ValueError(f"straggler_rate must be in [0, 1), "
                             f"got {straggler_rate}")
        srng = np.random.default_rng(
            np.random.SeedSequence([seed, round_idx, _STRAGGLER_TAG]))
        mask *= (srng.random(n_clients) >= straggler_rate)
    if mask.sum() == 0:
        raise ZeroParticipationError(
            f"round {round_idx}: no participating clients "
            f"(mode={mode!r}, clients_per_round={clients_per_round}, "
            f"rate={rate}, straggler_rate={straggler_rate}) — a 0/0 "
            f"aggregate would emit NaN updates; resample with a higher "
            f"rate or lower straggler_rate")
    return mask
