"""Paper math of the port: compression, EF memory, Armijo search, gamma
schedule, telemetry, single-node CSGD-ASSS with its baselines and the
DCSGD-ASSS exchange (twin of ``src/repro/core``)."""
