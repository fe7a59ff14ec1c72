"""Sparsity-aware aggregation of decoded payloads (twin of
``src/repro/fed/aggregate.py``, DESIGN.md §13).

Only :func:`support_weighted_mean` is here: every transport's guarded
decode divides each layer's sum by its valid-row count through it
(``core.dcsgd.valid_row_mean``).  The federated cohort's aggregation is
not ported yet.
"""
from __future__ import annotations

import torch


def support_weighted_mean(total: torch.Tensor,
                          support: torch.Tensor) -> torch.Tensor:
    """``total / support`` where supported, 0 elsewhere (never 0/0): a
    true division by the f32 ``support`` tensor on every device.  The 0
    is a scalar, not JAX's ``zeros_like(total)``: the same values without
    a dense fill to write and read."""
    return torch.where(support > 0.0, total / support.clamp_min(1.0), 0.0)
