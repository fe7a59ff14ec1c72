"""Compression telemetry (twin of ``src/repro/core/telemetry.py``).

Per worker per round, from five additive sums accumulated over leaves in
tree order and turned into ratios once:

* ``ef_backlog``   — ||m'|| / ||g||;
* ``cosine``       — cos(decode(own payload), g);
* ``decode_error`` — ||acc - decode(own)|| / ||acc||;
* ``eff_gamma``    — 1 - decode_error**2.

``sum g^2`` and ``sum acc^2`` come from the fused EF pass-1 kernel's
moments on the kernel path; the decoded-side sums touch only the k wire
entries.  Values are 0-dim float32 tensors on the working device, or
host float32 scalars once the trainer has read them back with its
metrics (the ``ef-coupled`` controller reads them there).
"""
from __future__ import annotations

import dataclasses

import torch

#: Guard for the ratio denominators (vanishes against real gradient
#: energy in f32, as in the JAX package).
_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class CompressionTelemetry:
    ef_backlog: torch.Tensor
    cosine: torch.Tensor
    decode_error: torch.Tensor
    eff_gamma: torch.Tensor

    @classmethod
    def init(cls, device) -> "CompressionTelemetry":
        """Neutral telemetry: zero backlog, perfect alignment."""
        def leaf(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        return cls(ef_backlog=leaf(0.0), cosine=leaf(1.0),
                   decode_error=leaf(0.0), eff_gamma=leaf(1.0))


@dataclasses.dataclass(frozen=True)
class TelemetrySums:
    """Additive accumulator behind :class:`CompressionTelemetry`."""

    g_sq: torch.Tensor
    acc_sq: torch.Tensor
    resid_sq: torch.Tensor
    own_sq: torch.Tensor
    own_dot_g: torch.Tensor

    @classmethod
    def zero(cls, device) -> "TelemetrySums":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(g_sq=z, acc_sq=z, resid_sq=z, own_sq=z, own_dot_g=z)

    def add(self, *, g_sq, acc_sq, resid_sq, own_sq,
            own_dot_g) -> "TelemetrySums":
        return TelemetrySums(
            g_sq=self.g_sq + g_sq,
            acc_sq=self.acc_sq + acc_sq,
            resid_sq=self.resid_sq + resid_sq,
            own_sq=self.own_sq + own_sq,
            own_dot_g=self.own_dot_g + own_dot_g)

    def add_dense(self, acc: torch.Tensor, g: torch.Tensor) -> "TelemetrySums":
        """An uncompressed leaf: decode == acc, residual exactly 0."""
        gf = g.float()
        accf = acc.float()
        acc_sq = (accf * accf).sum()
        return self.add(g_sq=(gf * gf).sum(), acc_sq=acc_sq,
                        resid_sq=torch.zeros_like(acc_sq), own_sq=acc_sq,
                        own_dot_g=(accf * gf).sum())

    def finalize(self) -> CompressionTelemetry:
        resid_sq = self.resid_sq
        return CompressionTelemetry(
            ef_backlog=torch.sqrt(resid_sq / (self.g_sq + _TINY)),
            cosine=self.own_dot_g / torch.sqrt(self.own_sq * self.g_sq
                                               + _TINY),
            decode_error=torch.sqrt(resid_sq / (self.acc_sq + _TINY)),
            eff_gamma=1.0 - resid_sq / (self.acc_sq + _TINY))


def sparse_own_sums(own_vals: torch.Tensor, own_idx: torch.Tensor,
                    g2: torch.Tensor):
    """(sum ||decode(own)||^2, sum <decode(own), g>) from the k decoded
    wire entries alone.  own_vals/own_idx: (L, k); g2: (L, d) f32."""
    d = g2.shape[-1]
    vals = own_vals.float()
    g_at = torch.gather(g2, -1, own_idx.clamp_max(d - 1).to(torch.int64))
    return (vals * vals).sum(), (vals * g_at).sum()


@dataclasses.dataclass(frozen=True)
class SearchTelemetry:
    """Armijo line-search signals of the round that just finished (the
    ``armijo-coupled`` controller's input); host float32 scalars."""

    alpha: float             # accepted step of round t
    alpha_prev: float        # accepted step of round t-1
    n_evals: float           # stopping-condition evaluations of round t
    n_evals_ema: float       # running mean of n_evals
