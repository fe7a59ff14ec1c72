"""Checkpoints of the port (twin of ``src/repro/checkpoint``)."""
