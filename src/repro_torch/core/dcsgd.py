"""DCSGD-ASSS exchange (twin of ``src/repro/core/dcsgd.py``, paper
Algorithm 3 steps 3-7).

Each data-parallel worker (one process of the group):

  3. forms ``acc = m + eta * grad`` per leaf,
  4. compresses ``acc`` and encodes it into bit-packed payload rows,
  5. all-gathers them over the group (the only compressed collective),
  6. decodes every worker's rows and applies the dense mean,
  7. keeps ``m' = acc - decode(own payload)``,

while leaves below the compression size travel densely.  Stacked leaves
(leading axis = layers) are compressed per layer.

Two transports here, registered in ``comm/transport.py``:

* ``bucketed`` (the default) — ONE fused-EF launch pair, ONE flat packed
  all_gather with one plain pack/unpack launch per bucket field section,
  and ONE dense all-reduce per step;
* ``perleaf`` — the reference schedule: per compressed leaf one fused-EF
  launch pair, one packed all_gather and one pack/unpack launch per field
  section (the ragged kernels when the compressor is adaptive), and one
  all-reduce per dense leaf;

and the stateful ``overlap`` (``comm/overlap.py``): the bucketed
schedule over a chunked ring, shipping the previous round's payload at
``delay=1``, and the stateful ``gossip`` (``comm/gossip.py``): the same
payload sent to a topology's neighbours only, each worker mixing itself
with them under an adaptive consensus step.

``bucketed`` and ``perleaf`` give the same updates, EF memory, byte
counts and telemetry, bit for bit.  With an adaptive compressor
(``max_gamma > 0``) a round compresses at its ``gamma_t``: selection
runs at the budget, entries past the round's count are masked behind
each row's count header (workers may send different counts; each row
is decoded at its own), the masked mass stays in the EF residual, and
the effective byte count prices only the valid fields.  With
``downlink_ctx`` the mean update then passes the server's EF
re-compression (``comm/downlink.py``).

Every decode runs the §16 verdicts (``wire.row_verdict``,
``quarantine_rows``) unless ``comm.faults.guards_active()`` is False:
a quarantined row adds nothing, the mean divides by each layer's
valid-row count, and a quarantined own row freezes the leaf's EF memory
for the round.  The stateful ``faulty`` transport (``comm/faults.py``)
wraps any of the others and corrupts the gathered rows before decode.

The EF memory may be f32 or bf16: every path, the dense leaves'
included, reads it as f32 before the kernels and writes m' back with
one rounding to the memory's dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.comm import faults
from repro_torch.comm import wire as wire_fmt
from repro_torch.comm.bucket import (build_bucket_plan, decode_guarded,
                                     encode_buckets)
from repro_torch.comm.downlink import DownlinkResult, apply_downlink
from repro_torch.comm.exchange import (all_reduce_mean, check_bucket_payload,
                                       check_payload, gather_packed)
from repro_torch.comm.transport import get_transport, register_transport
from repro_torch.fed.aggregate import support_weighted_mean
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ef_acc
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten
from .compression import Compressor, block_extract_sparse
from .leafmath import (jax_index_rules, leaf_2d, leaf_count,
                       per_layer_topk, plan_wire_bytes, scatter_layers,
                       scatter_pairs, select_and_encode)
from .telemetry import TelemetrySums, sparse_own_sums

f32 = np.float32


@functools.lru_cache(maxsize=8)
def _plan(shapes, stacked, comp):
    """The bucket plan depends only on the leaf shapes and the
    compressor, so it is built once per tree geometry, not every step."""
    return build_bucket_plan(shapes, stacked, comp)


def worker_compress_aggregate(grads, memory, eta, comp: Compressor,
                              group=None, stacked_mask=None, gamma_t=None,
                              transport: str = "bucketed",
                              transport_ctx=None, downlink_ctx=None):
    """Steps 3-7 of Algorithm 3 for a whole gradient tree.

    ``eta``: the step (host scalar or one-element tensor).  ``gamma_t``:
    this worker's round level (adaptive compressors; default
    ``comp.gamma``).  Returns ``(mean_update, new_memory, wire_bytes,
    effective_wire_bytes, telemetry)``; the byte counts are float32 host
    scalars, the rest tensors on the gradients' device.

    ``transport_ctx``: the context a stateful transport needs (``overlap``:
    a :class:`repro_torch.comm.overlap.OverlapCtx`, ``gossip``: a
    :class:`repro_torch.comm.gossip.GossipCtx`), None for the stateless
    ones; a stateful transport appends its new carried state
    to the return, a 6-tuple as JAX's.

    ``downlink_ctx`` (a :class:`repro_torch.comm.downlink.DownlinkCtx`):
    the mean update is re-compressed through the server's EF
    (``comm/downlink.py``) before it is returned, with no extra
    collective, and a :class:`~repro_torch.comm.downlink.DownlinkResult`
    (the new server state, the downlink's static and effective bytes) is
    appended to the return.  The uplink's outputs do not change."""
    tp = get_transport(transport)
    # JAX's order: the context first, then the downlink
    if tp.stateful and transport_ctx is None:
        raise ValueError(f"transport {transport!r} is stateful and needs "
                         "transport_ctx")
    if not tp.stateful and transport_ctx is not None:
        raise ValueError(f"transport {transport!r} is stateless; "
                         "transport_ctx must be None")
    if downlink_ctx is not None and tp.stateful:
        raise ValueError(
            f"downlink_ctx needs a replicated global aggregate to "
            f"re-compress; transport {transport!r} is stateful "
            "(gossip/overlap have no single server-side mean)")
    flat_g, structure = tree_flatten(grads)
    flat_m = tree_flatten(memory)[0]
    flat_s = ([g.dim() >= 2 for g in flat_g] if stacked_mask is None
              else tree_flatten(stacked_mask)[0])
    device = flat_g[0].device
    eta = torch.as_tensor(eta, dtype=torch.float32).to(device).reshape(1)
    if comp.adaptive and gamma_t is None:
        gamma_t = f32(comp.gamma)
    kw = {"ctx": transport_ctx} if tp.stateful else {}
    updates, new_mem, wire, eff_wire, sums, *new_state = tp.exchange(
        flat_g, flat_m, flat_s, eta, comp, group, gamma_t, **kw)
    out = (tree_unflatten(structure, new_mem), wire, eff_wire,
           sums.finalize())
    if downlink_ctx is None:
        return (tree_unflatten(structure, updates),) + out + tuple(new_state)
    # the server round's span, inside the trainer's exchange span
    with record_function("train_step.downlink"):
        updates, dl_state, down_wire, down_eff = apply_downlink(
            updates, flat_s, comp, downlink_ctx.state)
    return (tree_unflatten(structure, updates),) + out + (
        DownlinkResult(dl_state, down_wire, down_eff),)


def valid_row_mean(total: torch.Tensor, verdict: torch.Tensor):
    """``(total / max(n_valid, 1), quarantined rows)`` for an (L, d) sum
    of rows whose (W, L) ``verdict`` says which were valid: through
    ``support_weighted_mean``, a true division by the f32 count on every
    device, as jitted JAX divides by a traced count.  Quarantined rows
    scatter zero mass, so an all-invalid layer sums to +0.0 and gets
    +0.0, as JAX's ``total / max(0, 1)`` gives."""
    n_valid = verdict.to(torch.float32).sum(dim=0)[:, None]         # (L, 1)
    return (support_weighted_mean(total, n_valid),
            float(verdict.numel()) - n_valid.sum())


def _consume_decoded_leaf(g, m, g2f, g_vals, g_idx, L, d, W, rank,
                          use_fused, sent, resid, acc2, own=None,
                          verdict=None):
    """Post-gather per-leaf consumer, shared by the transports: the mean
    update, this worker's EF residual (own rows sliced from the gathered
    decode, or ``own`` = (vals, idx) when the gathered rows are not this
    round's, as under the overlap transport's delay 1), the decoded-side
    telemetry sums and the quarantined-row count.  Entries past the
    round's count are absent from the decoded own rows, so they land in
    the residual.

    ``verdict`` ((W, L) bool, or None when the decode ran unguarded):
    quarantined rows arrive as zero mass, the mean divides each layer by
    its valid-row count (``valid_row_mean``: a true division by an f32
    tensor, as jitted JAX divides by a traced count), and an invalid own
    row freezes the leaf's residual at the old memory (r = m in f32) —
    unless ``own`` is given: own rows that never crossed the wire are
    never quarantined.
    Unguarded, the mean divides by the static W, which jitted XLA
    computes as a product with f32(1/W).  Returns ``(update, memory,
    resid_sq, own_sq, own_dot, quar_rows)``; ``quar_rows`` is None
    unguarded."""
    # JAX's index rules once on the gathered pairs, shared by both scatters
    s_vals, s_idx = jax_index_rules(g_vals, g_idx, d)
    total = scatter_pairs(s_vals, s_idx, L, d)
    quar = None
    if verdict is None:
        mean_dense = total * float(f32(1.0) / f32(W))
    else:
        mean_dense, quar = valid_row_mean(total, verdict)
    if own is None:
        own_vals, own_idx = g_vals[rank], g_idx[rank]
        own_dense = scatter_pairs(s_vals[rank], s_idx[rank], L, d)
    else:
        own_vals, own_idx = own
        own_dense = scatter_layers(own_vals, own_idx, L, d)
    if use_fused:
        r = resid + (sent - own_dense)
    else:
        r = acc2 - own_dense
    if verdict is not None and own is None:
        r = torch.where(verdict[rank][:, None], r,
                        m.float().reshape(L, d))
    own_sq, own_dot = sparse_own_sums(own_vals, own_idx, g2f)
    return (mean_dense.reshape(g.shape), r.reshape(m.shape).to(m.dtype),
            (r * r).sum(), own_sq, own_dot, quar)


def _tree_plan(flat_g, flat_s, comp):
    return _plan(tuple(tuple(g.shape) for g in flat_g),
                 tuple(bool(s) for s in flat_s), comp)


@register_transport("perleaf", description=(
    "reference schedule: one packed all_gather + one launch set per leaf"))
def _perleaf_exchange(flat_g, flat_m, flat_s, eta, comp, group, gamma_t):
    """One fused-EF launch pair, one ``encode_rows``, one all_gather and
    one ``decode_rows`` per compressed leaf; one all-reduce per dense
    leaf."""
    W = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = flat_g[0].device
    plan = _tree_plan(flat_g, flat_s, comp)
    use_fused = comp.method == "block_topk"
    updates, new_mem = [], []
    sums = TelemetrySums.zero(device)
    for lane, g, m in zip(plan.leaves, flat_g, flat_m):
        if lane.dense:
            acc = ef_acc(m, g, eta).reshape(g.shape)
            updates.append(all_reduce_mean(acc, group))
            new_mem.append(torch.zeros_like(m))
            sums = sums.add_dense(acc, g)
            continue
        L, d, spec = lane.L, lane.d, lane.spec
        g2f = leaf_2d(g, lane.stacked).float()
        sent = resid = acc2 = None
        if use_fused:
            # threshold at the budget; the round's count masks the rest
            sent, resid, _, moments = ops.fused_ef_compress(
                leaf_2d(m, lane.stacked).float(), g2f, eta,
                comp.geometry_gamma, comp.block, telemetry=True)
            g_sq, acc_sq = moments[:, 0].sum(), moments[:, 1].sum()
            vals, idx = block_extract_sparse(sent, comp)
        else:
            acc2 = ef_acc(leaf_2d(m, lane.stacked), g2f, eta)
            g_sq, acc_sq = (g2f * g2f).sum(), (acc2 * acc2).sum()
            vals, idx = per_layer_topk(acc2, comp.k_for(d))
        count = leaf_count(comp, spec, gamma_t, d)
        payload = wire_fmt.encode_rows(
            vals, idx, spec, counts=None if count is None else
            wire_fmt.row_counts(count, L, device))
        check_payload(payload, spec, comp, d)
        all_rows = faults.maybe_corrupt(
            gather_packed(payload, group).reshape(-1, spec.row_words), spec,
            lane.index, L)
        g_vals, g_idx = wire_fmt.decode_rows(all_rows, spec)
        verdict = None
        if faults.guards_active():
            verdict = wire_fmt.row_verdict(all_rows, spec, g_vals, g_idx)
            g_vals, g_idx = wire_fmt.quarantine_rows(g_vals, g_idx, verdict)
            verdict = verdict.reshape(W, L)
        upd, mem_leaf, resid_sq, own_sq, own_dot, quar = \
            _consume_decoded_leaf(
                g, m, g2f, g_vals.reshape(W, L, spec.k),
                g_idx.reshape(W, L, spec.k), L, d, W, rank, use_fused, sent,
                resid, acc2, verdict=verdict)
        updates.append(upd)
        new_mem.append(mem_leaf)
        sums = sums.add(g_sq=g_sq, acc_sq=acc_sq, resid_sq=resid_sq,
                        own_sq=own_sq, own_dot_g=own_dot, quar_rows=quar)
    return (updates, new_mem) + plan_wire_bytes(plan, comp, gamma_t) \
        + (sums,)


@register_transport("bucketed", description=(
    "O(1) collectives: ONE flat packed all_gather + ONE all-reduce a step"))
def _bucketed_exchange(flat_g, flat_m, flat_s, eta, comp, group, gamma_t):
    """ONE fused-EF launch pair, ONE flat packed all_gather and ONE dense
    all-reduce per step; per-leaf accumulation order of the telemetry
    follows tree order, as in the JAX package."""
    W = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = flat_g[0].device
    plan = _tree_plan(flat_g, flat_s, comp)
    sel = select_and_encode(flat_g, flat_m, flat_s, eta, comp, gamma_t,
                            plan)

    decoded = verdicts = [None] * len(plan.leaves)
    if plan.total_words:
        payload = encode_buckets(plan, sel.enc_rows)
        check_bucket_payload(payload, plan, comp)
        decoded, verdicts = decode_guarded(plan,
                                           gather_packed(payload, group))

    dense_ids = list(plan.dense_ids)
    dense_acc = {i: ef_acc(flat_m[i], flat_g[i], eta).reshape(
        flat_g[i].shape) for i in dense_ids}
    dense_mean = {}
    if dense_ids:
        mean_cat = all_reduce_mean(
            torch.cat([dense_acc[i].reshape(-1) for i in dense_ids]), group)
        off = 0
        for i in dense_ids:
            size = dense_acc[i].numel()
            dense_mean[i] = mean_cat[off:off + size].reshape(
                dense_acc[i].shape)
            off += size

    updates, new_mem = [], []
    sums = TelemetrySums.zero(device)
    for lane, g, m in zip(plan.leaves, flat_g, flat_m):
        i = lane.index
        if lane.dense:
            updates.append(dense_mean[i])
            new_mem.append(torch.zeros_like(m))
            sums = sums.add_dense(dense_acc[i], g)
            continue
        g_vals, g_idx = decoded[i]
        upd, mem_leaf, resid_sq, own_sq, own_dot, quar = \
            _consume_decoded_leaf(
                g, m, sel.g2f[i], g_vals, g_idx, lane.L, lane.d, W, rank,
                sel.use_fused, sel.sent[i], sel.resid[i], sel.acc2[i],
                verdict=verdicts[i])
        updates.append(upd)
        new_mem.append(mem_leaf)
        sums = sums.add(g_sq=sel.leaf_g_sq[i], acc_sq=sel.leaf_acc_sq[i],
                        resid_sq=resid_sq, own_sq=own_sq, own_dot_g=own_dot,
                        quar_rows=quar)
    return (updates, new_mem) + plan_wire_bytes(plan, comp, gamma_t) \
        + (sums,)


def dense_aggregate(grads, eta, group=None):
    """Baseline: dense mean of eta*grad over the group (uncompressed
    wire); bytes are the f32 buffer the all-reduce moves."""
    device = tree_flatten(grads)[0][0].device
    eta = torch.as_tensor(eta, dtype=torch.float32).to(device)
    upd = tree_map(lambda g: all_reduce_mean(eta * g.float(), group), grads)
    wire = np.float32(sum(u.numel() * u.element_size()
                          for u in tree_flatten(upd)[0]))
    return upd, wire
