"""Overlapped compressed exchange — chunked ring + delay-1 double buffer
(twin of ``src/repro/comm/overlap.py``, DESIGN.md §14).

``transport="overlap"`` keeps the bucketed transport's selection, wire
format, EF contract and byte accounting but takes the collective off the
step's critical path two ways:

1. **Chunked ring** — the ONE flat bucketed all_gather becomes
   ``n_chunks * (W-1)`` point-to-point ring hops (``comm/ring.py``),
   bit-identical and byte-identical.
2. **One-step-stale aggregation** (``delay=1``, the default) — the step
   ships the PREVIOUS step's encoded payload, carried in
   :class:`OverlapState` (``TrainState.overlap``), so the collective's
   operands are ready the moment the step starts.  The trainer posts the
   ring's hops and the dense all-reduce on the carried buffers before
   the gradient (:func:`post_carried`); the exchange waits on them only
   when it decodes.  The aggregate applied at step t is the mean of step
   t-1's payloads.

**What stays current under staleness.**  Selection, encoding, the EF
residual and the telemetry sums always describe THIS step's accumulator:
the residual is ``acc - decode(own CURRENT payload)``, through
:func:`repro_torch.comm.wire.roundtrip_rows` — launch-free and bit for
bit a literal decode — once per group of leaves that share a spec.  Only
the applied mean and the ``effective_wire_bytes`` report (the buffer on
the wire this step) are one step old.  The encode of the current payload
and the decode of the gathered one launch the plain pack and unpack
kernels once per field section each, as ``bucketed`` does.

``delay=0`` is the bucketed schedule over the ring: bit for bit
``transport="bucketed"`` in updates, EF memory, wire and effective bytes
and telemetry.

The JAX package decodes with fault verdicts unless a fault campaign opts
out; on a clean payload that is bit for bit the division by W done here.
The quarantine of invalid rows and the own-row EF freeze come with the
faulty transport, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import wire as wire_fmt
from repro_torch.comm.bucket import BucketPlan, build_bucket_plan, \
    decode_buckets, encode_buckets
from repro_torch.comm.exchange import check_bucket_payload
from repro_torch.comm.ring import RingGather, ring_all_gather_start
from repro_torch.comm.transport import register_transport
from repro_torch.core.dcsgd import _consume_decoded_leaf, _tree_plan
from repro_torch.core.leafmath import plan_wire_bytes, select_and_encode
from repro_torch.core.telemetry import TelemetrySums
from repro_torch.kernels.ref import ef_acc

__all__ = [
    "OverlapConfig",
    "OverlapState",
    "OverlapStart",
    "OverlapCtx",
    "init_overlap_state",
    "post_carried",
    "overlap_exchange",
]

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Static knobs of the overlap transport (``--overlap-*`` CLI flags).

    ``n_chunks``: word-aligned ring sections (clamped to the buffer
    length; more chunks = more, smaller hops).  ``delay``: 0 = ship this
    step's payload (bit-exact bucketed parity mode), 1 = ship the carried
    previous payload (the overlapped mode; aggregate lands one step
    late).
    """

    n_chunks: int = 1
    delay: int = 1

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(
                f"overlap n_chunks must be >= 1, got {self.n_chunks}")
        if self.delay not in (0, 1):
            raise ValueError(
                f"overlap delay must be 0 or 1, got {self.delay}")


@dataclasses.dataclass(frozen=True)
class OverlapState:
    """Double-buffered carried state of one worker.

    ``payload``/``dense``: the bucket buffer (int32 words; JAX's are
    uint32, the bits are the same) and the concatenated f32 dense
    accumulators this worker encoded LAST step — the operands of this
    step's collective at ``delay=1``.  ``eff_wire``: the effective bytes
    of that payload (computed at encode time, reported when it ships),
    a host float32.  ``seeded``: 0.0 until the first encode lands in the
    buffer, then 1.0 (host float32); the ``staleness`` metric reads it.
    """

    payload: torch.Tensor   # (total_words,) int32
    dense: torch.Tensor     # (dense_size,) f32
    eff_wire: np.float32
    seeded: np.float32


class OverlapStart:
    """A payload's and its dense lanes' collectives in flight: the ring
    all-gather of the words and the all-reduce of the dense buffer (each
    None when its buffer is empty)."""

    def __init__(self, payload: torch.Tensor, dense: torch.Tensor, group,
                 n_chunks: int):
        self.ring: RingGather | None = None
        self.dense: tuple | None = None
        if payload.numel():
            self.ring = ring_all_gather_start(payload, group, n_chunks)
        if dense.numel():
            buf = dense.clone()
            self.dense = (buf, dist.all_reduce(buf, group=group,
                                               async_op=True))

    def gathered(self) -> torch.Tensor:
        """(W, total_words) rows in rank order."""
        return self.ring.wait()

    def dense_mean(self, W: int) -> torch.Tensor:
        buf, work = self.dense
        work.wait()
        return buf / W


@dataclasses.dataclass(frozen=True)
class OverlapCtx:
    """Static config + this worker's carried state; ``started``: the
    carried buffers' collectives if the caller posted them early
    (:func:`post_carried`), else the exchange posts them itself."""

    cfg: OverlapConfig
    state: OverlapState
    started: OverlapStart | None = None


def post_carried(state: OverlapState, group=None,
                 n_chunks: int = 1) -> OverlapStart:
    """Post the ring hops on ``state.payload`` and the all-reduce of
    ``state.dense`` now (``async_op``); the delay-1 exchange waits on them
    at decode.  Every worker must post them at the same point."""
    return OverlapStart(state.payload, state.dense, group, n_chunks)


def _zero_payload_eff_bytes(plan: BucketPlan) -> float:
    """Effective bytes of the all-zero buffer the warm-up step ships:
    ragged rows decode count 0 (header words only count as effective),
    non-ragged rows always ship full rows, dense leaves ship dense."""
    eff = 0.0
    for lane in plan.leaves:
        if lane.dense:
            eff += float(math.prod(lane.shape)) * 4.0
        elif lane.spec.ragged:
            eff += lane.L * float(lane.spec.effective_row_bytes(0))
        else:
            eff += lane.L * lane.spec.row_bytes
    return eff


def init_overlap_state(shapes, stacked, comp, device=None) -> OverlapState:
    """Fresh carried state for a gradient tree with flat leaf ``shapes``
    and per-leaf ``stacked`` flags — the SAME flags the worker passes to
    ``worker_compress_aggregate`` (``lm.stacked_mask``), or the payload
    geometry will not line up (the exchange raises on any mismatch)."""
    plan = build_bucket_plan([tuple(s) for s in shapes], list(stacked),
                             comp)
    dense_size = sum(math.prod(lane.shape) for lane in plan.leaves
                     if lane.dense)
    return OverlapState(
        payload=torch.zeros((plan.total_words,), dtype=torch.int32,
                            device=device),
        dense=torch.zeros((dense_size,), dtype=torch.float32,
                          device=device),
        eff_wire=f32(_zero_payload_eff_bytes(plan)),
        seeded=f32(0.0))


def _own_roundtrip(lanes, sel) -> list:
    """The delay-1 own rows: ``roundtrip_rows`` of this step's encoded
    fields, batched across same-spec leaves (row-wise, so bit-identical
    per row to one call a leaf)."""
    own = [None] * len(lanes)
    by_spec: dict = {}
    for lane in lanes:
        if not lane.dense:
            by_spec.setdefault(lane.spec, []).append(lane)
    for gspec, group in by_spec.items():
        vals = torch.cat([sel.enc_rows[ln.index][0] for ln in group])
        idxs = torch.cat([sel.enc_rows[ln.index][1] for ln in group])
        counts = None
        if gspec.ragged:
            counts = torch.cat([
                sel.enc_rows[ln.index][2]
                if sel.enc_rows[ln.index][2] is not None
                else wire_fmt.row_counts(gspec.full_count, ln.L, vals.device)
                for ln in group])
        rv, ri = wire_fmt.roundtrip_rows(vals, idxs, gspec, counts=counts)
        off = 0
        for ln in group:
            own[ln.index] = (rv[off:off + ln.L], ri[off:off + ln.L])
            off += ln.L
    return own


@register_transport("overlap", stateful=True, description=(
    "chunked-ring, double-buffered exchange: the collective ships the "
    "previous step's payload concurrently with this step's compute"))
def overlap_exchange(flat_g, flat_m, flat_s, eta, comp, group, gamma_t, *,
                     ctx: OverlapCtx):
    """Bucketed semantics on an overlapped schedule.

    At ``delay=1`` the collective (ring + dense all-reduce) consumes only
    ``ctx.state``, posted early by the caller or here; EF and telemetry
    stay current via the launch-free own-payload roundtrip.  At
    ``delay=0`` the own rows come off the gathered decode exactly as the
    bucketed consumer takes them.  Returns ``(updates, new_mem, wire,
    eff_wire, sums, new_state)``.
    """
    cfg, state = ctx.cfg, ctx.state
    stale = cfg.delay == 1
    W = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = flat_g[0].device
    plan = _tree_plan(flat_g, flat_s, comp)
    lanes = plan.leaves

    sel = select_and_encode(flat_g, flat_m, flat_s, eta, comp, gamma_t,
                            plan)

    # ---- CURRENT-step buffers (next step's collective operands) ---------
    payload = torch.zeros((0,), dtype=torch.int32, device=device)
    if plan.total_words:
        payload = encode_buckets(plan, sel.enc_rows)
        check_bucket_payload(payload, plan, comp)
    if tuple(state.payload.shape) != tuple(payload.shape):
        raise ValueError(
            f"OverlapState.payload shape {tuple(state.payload.shape)} does "
            f"not match the bucket plan's ({tuple(payload.shape)}) — init "
            "the state with the same leaf shapes/stacked_mask/compressor "
            "the worker uses (see init_overlap_state)")

    dense_ids = list(plan.dense_ids)
    dense_acc = {i: ef_acc(flat_m[i], flat_g[i], eta).reshape(
        flat_g[i].shape) for i in dense_ids}
    dense_cat = (torch.cat([dense_acc[i].reshape(-1) for i in dense_ids])
                 if dense_ids else
                 torch.zeros((0,), dtype=torch.float32, device=device))
    if tuple(state.dense.shape) != tuple(dense_cat.shape):
        raise ValueError(
            f"OverlapState.dense shape {tuple(state.dense.shape)} does not "
            f"match the plan's concatenated dense size "
            f"({tuple(dense_cat.shape)})")

    # ---- the collective ships the carried (stale) or current buffer -----
    if stale:
        started = ctx.started if ctx.started is not None else \
            post_carried(state, group, cfg.n_chunks)
    else:
        started = OverlapStart(payload, dense_cat, group, cfg.n_chunks)
    decoded = [None] * len(lanes)
    if plan.total_words:
        decoded = decode_buckets(plan, started.gathered())
    dense_mean = {}
    if dense_ids:
        mean_cat = started.dense_mean(W)
        off = 0
        for i in dense_ids:
            size = dense_acc[i].numel()
            dense_mean[i] = mean_cat[off:off + size].reshape(
                dense_acc[i].shape)
            off += size

    own_rt = _own_roundtrip(lanes, sel) if stale else [None] * len(lanes)

    # ---- per-leaf consumers, ORIGINAL tree order (bucketed parity) ------
    updates, new_mem = [], []
    sums = TelemetrySums.zero(device)
    for lane, g, m in zip(lanes, flat_g, flat_m):
        i = lane.index
        if lane.dense:
            updates.append(dense_mean[i])
            new_mem.append(torch.zeros_like(m))
            sums = sums.add_dense(dense_acc[i], g)
            continue
        g_vals, g_idx = decoded[i]
        upd, mem_leaf, resid_sq, own_sq, own_dot = _consume_decoded_leaf(
            g, m, sel.g2f[i], g_vals, g_idx, lane.L, lane.d, W, rank,
            sel.use_fused, sel.sent[i], sel.resid[i], sel.acc2[i],
            own=own_rt[i])
        updates.append(upd)
        new_mem.append(mem_leaf)
        sums = sums.add(g_sq=sel.leaf_g_sq[i], acc_sq=sel.leaf_acc_sq[i],
                        resid_sq=resid_sq, own_sq=own_sq, own_dot_g=own_dot)

    # wire bytes are static per plan (the full buffer crosses the wire
    # every step, carried or not); effective bytes describe the buffer
    # actually shipped THIS step — the carried one under delay=1
    wire, cur_eff = plan_wire_bytes(plan, comp, gamma_t)
    eff_out = state.eff_wire if stale else cur_eff
    new_state = OverlapState(payload=payload, dense=dense_cat,
                             eff_wire=f32(cur_eff), seeded=f32(1.0))
    return updates, new_mem, wire, eff_out, sums, new_state
