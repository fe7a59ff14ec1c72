"""Paper math of the port: compression, EF memory, Armijo search, gamma
schedule, telemetry, single-node CSGD-ASSS with its baselines, ACGD and
the DCSGD-ASSS exchange (twin of ``src/repro/core``)."""
from .acgd import ACGD, AcgdAux, AcgdConfig, AcgdState, acgd

__all__ = ["ACGD", "AcgdAux", "AcgdConfig", "AcgdState", "acgd"]
