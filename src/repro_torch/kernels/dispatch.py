"""Kernel dispatch: one place decides which implementation runs per op.

Twin of ``src/repro/kernels/dispatch.py``.  Every op registered here has
two implementations:

* ``ref``  — the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
* ``cuda`` — the hand-written CUDA kernel's wrapper.

The implementation follows the device of the op's first tensor argument:
a CPU tensor takes ``ref``, a CUDA tensor launches the kernel (which
raises on what it cannot take).  There is no fallback from one to the
other, and no other device is accepted.
"""
from __future__ import annotations

from typing import Callable

import torch

_REGISTRY: dict[str, dict[str, Callable]] = {}


def register_op(name: str, *, ref: Callable, cuda: Callable) -> None:
    _REGISTRY[name] = {"ref": ref, "cuda": cuda}


def registered() -> dict[str, tuple[str, ...]]:
    """op -> impl names (introspection for tests)."""
    return {op: tuple(impls) for op, impls in _REGISTRY.items()}


def resolve(x: torch.Tensor) -> str:
    """The impl for a tensor on ``x``'s device."""
    if x.device.type == "cpu":
        return "ref"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel implementation for device {x.device}")


def call(name: str, x: torch.Tensor, *args, **kwargs):
    """Run op ``name`` with first tensor argument ``x``."""
    return _REGISTRY[name][resolve(x)](x, *args, **kwargs)
