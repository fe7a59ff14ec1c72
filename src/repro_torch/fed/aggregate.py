"""Sparsity-aware aggregation of decoded top-k client payloads (twin of
``src/repro/fed/aggregate.py``, DESIGN.md §13, ``fed_dropout_avg``-style).

The dense mean divides every coordinate's sum by the full participant
count: with top-k payloads that averages implicit zeros into every
coordinate a client never sent, shrinking the update by roughly the
per-coordinate sparsity.

``aggregation="support"`` divides each coordinate's sum by its
**nonzero-support count** — how many *participating* clients shipped a
nonzero decoded value there.  Support is taken from the decoded values
themselves (after JAX's index rules, so an entry the scatter drops never
counts), so block-padding clamp entries and masked-beyond-k_t tails
(both decode to exactly 0.0) never count, and no extra wire field is
needed.  Coordinates nobody sent get 0 (no update), not 0/0.
``aggregation="mean"`` keeps the zero-averaging dense mean as the
reference.  When every participant sends every coordinate the two are
the same division on the same operands, bit for bit.

Every division here is a true division by an f32 tensor on the data's
device, as jitted JAX divides by a traced count (on CUDA a host scalar
divisor would become a product with its reciprocal).
:func:`support_weighted_mean` is also every transport's guarded mean
(``core.dcsgd.valid_row_mean``).
"""
from __future__ import annotations

import torch

from repro_torch.core.leafmath import jax_index_rules, scatter_pairs

AGGREGATIONS = ("support", "mean")


def validate_aggregation(name: str) -> None:
    if name not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {name!r} "
                         f"(want one of {AGGREGATIONS})")


def scatter_with_support(vals: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, L: int, d: int):
    """Scatter (N, L, k) decoded client rows into a dense (L, d) f32 sum
    and its per-coordinate support count.

    ``weights``: (N,) 0/1 participation on the rows' device —
    non-participants contribute to neither.  Support counts clients with
    a NONZERO decoded value at the coordinate, so decode-to-zero entries
    (ragged tails, padding clamps, values quantized to zero) and entries
    the scatter drops are invisible, matching what receivers apply."""
    return scatter_ruled(*jax_index_rules(vals, idx, d), weights, L, d)


def scatter_ruled(s_vals: torch.Tensor, s_idx: torch.Tensor,
                  weights: torch.Tensor, L: int, d: int):
    """:func:`scatter_with_support` of pairs that already went through
    ``jax_index_rules`` (the cohort applies them once a leaf and also
    scatters its own rows from them).  A dropped entry is -0.0 there, so
    it adds nothing and counts as no support, as JAX's scatter drops it
    before either sum."""
    w = weights.to(torch.float32).reshape(-1, 1, 1)
    total = scatter_pairs(s_vals * w, s_idx, L, d)
    support = scatter_pairs((s_vals != 0.0).to(torch.float32) * w, s_idx,
                            L, d)
    return total, support


def support_weighted_mean(total: torch.Tensor,
                          support: torch.Tensor) -> torch.Tensor:
    """``total / support`` where supported, 0 elsewhere (never 0/0): a
    true division by the f32 ``support`` tensor on every device.  The 0
    is a scalar, not JAX's ``zeros_like(total)``: the same values without
    a dense fill to write and read."""
    return torch.where(support > 0.0, total / support.clamp_min(1.0), 0.0)


def zero_averaged_mean(total: torch.Tensor,
                       n_participants: torch.Tensor) -> torch.Tensor:
    """The dense-mean reference: unsent coordinates average as zeros.
    ``n_participants``: an f32 tensor on ``total``'s device."""
    return total / n_participants.to(torch.float32).clamp_min(1.0)


def aggregate_ruled(s_vals, s_idx, weights, L: int, d: int,
                    n_participants: torch.Tensor,
                    aggregation: str) -> torch.Tensor:
    """:func:`aggregate_decoded` of pairs that already went through
    ``jax_index_rules``."""
    validate_aggregation(aggregation)
    total, support = scatter_ruled(s_vals, s_idx, weights, L, d)
    if aggregation == "support":
        return support_weighted_mean(total, support)
    return zero_averaged_mean(total, n_participants)


def aggregate_decoded(vals: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, L: int, d: int,
                      n_participants: torch.Tensor,
                      aggregation: str) -> torch.Tensor:
    """One leaf's aggregated (L, d) update from all N decoded client rows.

    When support equals ``n_participants`` at every coordinate (every
    participant sent every coordinate — gamma at budget, 32-bit values)
    the two modes perform the identical division and agree bit for bit.
    """
    validate_aggregation(aggregation)
    return aggregate_ruled(*jax_index_rules(vals, idx, d), weights, L, d,
                           n_participants, aggregation)
