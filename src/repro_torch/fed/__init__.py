"""Federated aggregation (twin of ``src/repro/fed``): so far the
support-weighted mean that the overlap transport's guarded decode uses."""
