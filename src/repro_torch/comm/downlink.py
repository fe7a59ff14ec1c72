"""Compressed downlink: the server's EF re-compression of the aggregate
(twin of ``src/repro/comm/downlink.py``, DESIGN.md §15).

The uplink ships bit-packed payload rows; with ``downlink="dense"`` the
decoded mean returns to every worker as f32, charged in full.  With
``downlink="compressed"`` the mean update is pushed through the same
per-leaf :class:`~repro_torch.comm.wire.WireSpec` geometry with its own
server-side error-feedback memory, and each worker applies
``decode(downlink payload)`` instead of the dense mean.

The gathered aggregate is identical on every worker, so the server is
simulated: every worker runs the same compression and EF, and no
collective is added.  What changes is the accounted return direction:
the packed payload rows (ragged counts at the downlink's gamma) in place
of the dense aggregate.  The server residual ``M_s' = (M_s + mean) -
decode(payload)`` is carried in :class:`DownlinkState`, so what the
downlink drops this round is sent in a later one.

The decode is :func:`repro_torch.comm.wire.roundtrip_rows` — the values
``decode_rows(encode_rows(...))`` gives, without packed words — once per
group of leaves that share a spec: the downlink launches no pack/unpack
kernel, as the JAX package's launches none.  The selection is plain
PyTorch (``core.leafmath.compress_leaf``), as JAX's is ``lax.top_k``.
Leaves the uplink ships dense return dense, charged at 4 bytes an entry.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm import wire as wire_fmt
from repro_torch.comm.bucket import BucketPlan, build_bucket_plan
from repro_torch.core.leafmath import compress_leaf, leaf_count, \
    plan_wire_bytes, scatter_layers

MODES = ("dense", "compressed")


@dataclasses.dataclass(frozen=True)
class DownlinkState:
    """The server's carried state, the same on every worker.

    ``memory``: the server EF residual, one flat f32 tensor holding the
    compressed leaves' (L, d) rows back to back in tree order (dense
    leaves have none: their aggregate returns exact).  ``gamma``: the
    downlink gamma_t this round's ragged counts are masked at, a host
    float32, advanced by the train step before the exchange."""

    memory: torch.Tensor   # (server_size,) f32
    gamma: np.float32


@dataclasses.dataclass(frozen=True)
class DownlinkCtx:
    """This round's server state, handed to
    ``worker_compress_aggregate(downlink_ctx=...)``."""

    state: DownlinkState


class DownlinkResult(NamedTuple):
    """Last element of an exchange's return with the downlink on."""

    state: DownlinkState
    wire_bytes: np.float32       # the static downlink budget
    eff_wire_bytes: np.float32   # the ragged content at the downlink gamma


@functools.lru_cache(maxsize=8)
def _plan(shapes, stacked, comp) -> BucketPlan:
    return build_bucket_plan(shapes, stacked, comp)


def downlink_plan(shapes, stacked, comp) -> BucketPlan:
    """The uplink's bucket plan, unchanged: the same (L, d) geometry,
    WireSpecs and dense/compressed split."""
    return _plan(tuple(tuple(s) for s in shapes),
                 tuple(bool(s) for s in stacked), comp)


def server_memory_size(plan: BucketPlan) -> int:
    """f32 words of server EF memory: L*d summed over compressed
    leaves."""
    return sum(ln.L * ln.d for ln in plan.leaves if not ln.dense)


def init_downlink_state(shapes, stacked, comp, gamma0: float,
                        device=None) -> DownlinkState:
    """A fresh server state for a gradient tree with flat leaf ``shapes``
    and per-leaf ``stacked`` flags — the flags the worker passes to
    ``worker_compress_aggregate``, or the memory offsets do not line up
    (the exchange raises on a size mismatch)."""
    size = server_memory_size(downlink_plan(shapes, stacked, comp))
    return DownlinkState(
        memory=torch.zeros((size,), dtype=torch.float32, device=device),
        gamma=np.float32(gamma0))


def dense_downlink_bytes(shapes) -> float:
    """Bytes a link carries under the DENSE downlink: the whole f32
    aggregate, the reference the compressed downlink must beat."""
    return float(sum(int(np.prod(tuple(s), dtype=np.int64)) for s in shapes)
                 * 4)


def downlink_wire_bytes(plan: BucketPlan) -> float:
    """Static bytes a link carries under ``downlink="compressed"``: the
    packed payload rows of compressed leaves and f32 for the rest."""
    total = 0.0
    for ln in plan.leaves:
        if ln.dense:
            total += int(np.prod(ln.shape, dtype=np.int64)) * 4
        else:
            total += ln.L * ln.spec.row_bytes
    return float(total)


def apply_downlink(flat_updates, flat_s, comp, state: DownlinkState):
    """One server round over the decoded mean updates (flat, tree order).

    ``flat_updates``: the transport's f32 mean updates, dense leaves
    included.  Returns ``(new_updates, new_state, wire, eff)``:
    ``new_updates[i]`` is the decoded server payload of a compressed leaf
    (dense leaves pass through exactly), ``new_state`` carries the server
    residual, and the host float32 byte counts price one link's return
    direction (static budget, ragged content at ``state.gamma``).  The
    same on every worker, so no collective."""
    plan = downlink_plan([u.shape for u in flat_updates], flat_s, comp)
    lanes = plan.leaves
    n = len(lanes)
    size = server_memory_size(plan)
    if tuple(state.memory.shape) != (size,):
        raise ValueError(
            f"DownlinkState.memory shape {tuple(state.memory.shape)} does "
            f"not match the plan's server size (({size},)) — init the "
            "state with the same leaf shapes/stacked_mask/compressor the "
            "worker uses (see init_downlink_state)")

    acc = [None] * n          # (L, d) server accumulators
    rows = [None] * n         # (vals, idx, counts) per compressed leaf
    mem_off = 0
    for ln in lanes:
        if ln.dense:
            continue
        i, L, d = ln.index, ln.L, ln.d
        u2 = flat_updates[i].float().reshape(L, d)
        m2 = state.memory[mem_off:mem_off + L * d].reshape(L, d)
        mem_off += L * d
        acc[i] = m2 + u2
        vals, idx, _ = compress_leaf(acc[i], comp, ln.stacked)
        count = leaf_count(comp, ln.spec, state.gamma, d)
        rows[i] = (vals, idx, None if count is None else
                   wire_fmt.row_counts(count, L, vals.device))

    # decode(encode(...)) without packed words, one round trip per group
    # of leaves that share a spec
    decoded = [None] * n
    by_spec: dict = {}
    for ln in lanes:
        if not ln.dense:
            by_spec.setdefault(ln.spec, []).append(ln)
    for gspec, group in by_spec.items():
        vals = torch.cat([rows[ln.index][0] for ln in group])
        idxs = torch.cat([rows[ln.index][1] for ln in group])
        cts = None
        if gspec.ragged:
            cts = torch.cat([
                rows[ln.index][2] if rows[ln.index][2] is not None
                else wire_fmt.row_counts(gspec.full_count, ln.L, vals.device)
                for ln in group])
        rv, ri = wire_fmt.roundtrip_rows(vals, idxs, gspec, counts=cts)
        off = 0
        for ln in group:
            decoded[ln.index] = (rv[off:off + ln.L], ri[off:off + ln.L])
            off += ln.L

    new_updates = list(flat_updates)
    mem_parts = []
    for ln in lanes:
        if ln.dense:
            continue
        i = ln.index
        dec = scatter_layers(*decoded[i], ln.L, ln.d)
        mem_parts.append((acc[i] - dec).reshape(-1))
        new_updates[i] = dec.reshape(flat_updates[i].shape)
    new_memory = torch.cat(mem_parts) if mem_parts else \
        state.memory.new_zeros((0,))
    wire, eff = plan_wire_bytes(plan, comp, state.gamma)
    return new_updates, DownlinkState(new_memory, state.gamma), wire, eff
