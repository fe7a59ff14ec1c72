"""Training entry points of the port (twin of ``src/repro/launch``)."""
