"""The dense decoder-only LM of the port (twin of ``src/repro/models``)."""
