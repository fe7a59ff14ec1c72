"""Synthetic data of the port (twin of ``src/repro/data``)."""
