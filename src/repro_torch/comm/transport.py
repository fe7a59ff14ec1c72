"""Transport registry (twin of ``src/repro/comm/transport.py``): the one
source of the exchange schedules' names, for
``OptimizerConfig.transport``, the ``--transport`` flag and
``core.dcsgd.worker_compress_aggregate`` alike.

A transport moves one round's compressed payload across the
data-parallel group; every registered exchange function implements steps
3-7 of Algorithm 3 for the whole flattened tree::

    fn(flat_g, flat_m, flat_s, eta, comp, group, gamma_t)
        -> (updates, new_mem, wire_bytes, effective_wire_bytes, sums)

``flat_g`` / ``flat_m`` are the gradient and EF-memory leaves,
``flat_s`` the per-leaf stacked flags, ``eta`` one f32 element on the
working device, ``gamma_t`` the round's host float32 level (None unless
the compressor is adaptive); ``sums`` is a
:class:`~repro_torch.core.telemetry.TelemetrySums`.

*Stateful* transports (``stateful=True``) carry state of their own
across rounds: they take a ``ctx`` keyword and return that state as a
sixth element::

    fn(..., gamma_t, ctx=ctx) -> (updates, new_mem, wire, eff, sums, state)

The port registers ``bucketed`` and ``perleaf`` (both in
``core/dcsgd.py``) and the stateful ``overlap`` (``comm/overlap.py``) and
``gossip`` (``comm/gossip.py``); the JAX package's stateful faulty
transport is not ported.  The compressed downlink, which needs a single
global aggregate, refuses a stateful transport as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Transport:
    name: str
    exchange: Callable
    stateful: bool = False
    description: str = ""


_REGISTRY: dict[str, Transport] = {}


def register_transport(name: str, *, stateful: bool = False,
                       description: str = ""):
    """Decorator: register an exchange function under ``name``; a second,
    different function under one name is an error."""
    def deco(fn: Callable) -> Callable:
        prev = _REGISTRY.get(name)
        if prev is not None and prev.exchange is not fn:
            raise ValueError(f"transport {name!r} already registered")
        _REGISTRY[name] = Transport(name, fn, stateful, description)
        return fn
    return deco


def _ensure_registered() -> None:
    """Import the modules that register the transports (lazily: they
    import this package)."""
    import repro_torch.comm.gossip  # noqa: F401  (registers "gossip")
    import repro_torch.comm.overlap  # noqa: F401  (registers "overlap")
    import repro_torch.core.dcsgd  # noqa: F401  (bucketed, perleaf)


def transport_names() -> tuple[str, ...]:
    """Sorted valid names (the CLI's ``choices``)."""
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def unknown_transport_message(name: str) -> str:
    """The error text for an invalid transport name."""
    want = " | ".join(f"'{n}'" for n in transport_names())
    return f"unknown transport {name!r} (want {want})"


def get_transport(name: str) -> Transport:
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(unknown_transport_message(name)) from None


def validate_transport(name: str) -> str:
    """Config-time check (``OptimizerConfig.__post_init__``)."""
    get_transport(name)
    return name
