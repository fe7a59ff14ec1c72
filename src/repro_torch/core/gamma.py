"""Per-round compression level (twin of ``src/repro/core/gamma.py``).
The port carries the ``fixed`` schedule, the paper's setting: every
round compresses at the compressor's own gamma.  The adaptive schedules
are not ported yet."""
from __future__ import annotations

import numpy as np


def gamma_init(comp) -> np.float32:
    """gamma_t of the fixed schedule, for the optimizer state."""
    return np.float32(comp.gamma)
