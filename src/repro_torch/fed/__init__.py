"""Federated cohort simulation tier (twin of ``src/repro/fed``, DESIGN.md
§13).

A cohort layer above the data-parallel group: each worker runs
``C = n_clients / W`` simulated clients through the compressed
exchange, so one process stands in for many heterogeneous federated
clients per round.

* :mod:`repro_torch.fed.sampling`  — host-side deterministic
  participation masks (Bernoulli / fixed-size sampling, straggler
  dropout).
* :mod:`repro_torch.fed.aggregate` — sparsity-aware support-weighted
  aggregation of decoded top-k payloads (``fed_dropout_avg``-style),
  with the dense zero-averaging mean retained as the reference.
* :mod:`repro_torch.fed.clients`   — per-client EF memory / gamma /
  Armijo state and the cohort exchange itself (ONE all_gather + ONE
  all-reduce for the whole cohort, regardless of client count).
"""
from .aggregate import (AGGREGATIONS, aggregate_decoded,
                        scatter_with_support, support_weighted_mean,
                        zero_averaged_mean)
from .clients import (ClientState, cohort_compress_aggregate,
                      init_client_state, local_participation,
                      per_client_wire_bytes)
from .sampling import (SAMPLERS, ZeroParticipationError,
                       participation_mask)

__all__ = [
    "AGGREGATIONS", "SAMPLERS", "ClientState", "ZeroParticipationError",
    "aggregate_decoded", "cohort_compress_aggregate", "init_client_state",
    "local_participation", "participation_mask", "per_client_wire_bytes",
    "scatter_with_support", "support_weighted_mean", "zero_averaged_mean",
]
