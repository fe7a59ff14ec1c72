"""Paper math of the port: compression, EF memory, Armijo search, gamma
schedule, telemetry and the DCSGD-ASSS exchange (twin of
``src/repro/core``)."""
