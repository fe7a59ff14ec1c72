"""DCSGD-ASSS exchange (twin of ``src/repro/core/dcsgd.py``, paper
Algorithm 3 steps 3-7, the default ``bucketed`` transport).

Each data-parallel worker (one process of the group):

  3. forms ``acc = m + eta * grad`` per leaf,
  4. compresses ``acc`` and encodes ONE flat bit-packed payload,
  5. all-gathers it over the group (the only compressed collective),
  6. decodes every worker's payload and applies the dense mean,
  7. keeps ``m' = acc - decode(own payload)``,

while leaves below the compression size travel densely in ONE all-reduce.
Stacked leaves (leading axis = layers) are compressed per layer.

The perleaf, gossip, overlap, downlink and faulty transports of the JAX
package are not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.bucket import (build_bucket_plan, decode_buckets,
                                     encode_buckets)
from repro_torch.comm.exchange import (all_reduce_mean, check_bucket_payload,
                                       gather_packed)
from repro_torch.kernels.ref import ef_acc
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten
from .compression import Compressor
from .leafmath import scatter_layers, select_and_encode
from .telemetry import TelemetrySums, sparse_own_sums


@functools.lru_cache(maxsize=8)
def _plan(shapes, stacked, comp):
    """The bucket plan depends only on the leaf shapes and the
    compressor, so it is built once per tree geometry, not every step."""
    return build_bucket_plan(shapes, stacked, comp)


def worker_compress_aggregate(grads, memory, eta, comp: Compressor,
                              group=None, stacked_mask=None):
    """Steps 3-7 of Algorithm 3 for a whole gradient tree.

    ``eta``: the step (host scalar or one-element tensor).  Returns
    ``(mean_update, new_memory, wire_bytes, telemetry)``; the byte count
    is a float32 host scalar, the rest tensors on the gradients'
    device."""
    flat_g, structure = tree_flatten(grads)
    flat_m = tree_flatten(memory)[0]
    flat_s = ([g.dim() >= 2 for g in flat_g] if stacked_mask is None
              else tree_flatten(stacked_mask)[0])
    device = flat_g[0].device
    eta = torch.as_tensor(eta, dtype=torch.float32).to(device).reshape(1)
    updates, new_mem, wire, sums = _bucketed_exchange(
        flat_g, flat_m, flat_s, eta, comp, group)
    return (tree_unflatten(structure, updates),
            tree_unflatten(structure, new_mem), wire, sums.finalize())


def _consume_decoded_leaf(g, m, g2f, g_vals, g_idx, spec, L, d, W, rank,
                          use_fused, sent, resid, acc2):
    """Post-gather per-leaf consumer: the mean update, this worker's EF
    residual (own rows sliced from the gathered decode), the byte cost
    and the decoded-side telemetry sums."""
    total = scatter_layers(g_vals, g_idx, L, d)
    mean_dense = total / W
    wire_add = np.float32(L * spec.row_bytes)
    own_vals, own_idx = g_vals[rank], g_idx[rank]
    own_dense = scatter_layers(own_vals, own_idx, L, d)
    if use_fused:
        r = resid + (sent - own_dense)
    else:
        r = acc2 - own_dense
    own_sq, own_dot = sparse_own_sums(own_vals, own_idx, g2f)
    return (mean_dense.reshape(g.shape), r.reshape(m.shape).to(m.dtype),
            wire_add, (r * r).sum(), own_sq, own_dot)


def _bucketed_exchange(flat_g, flat_m, flat_s, eta, comp, group):
    """ONE fused-EF launch pair, ONE flat packed all_gather and ONE dense
    all-reduce per step; per-leaf accumulation order of bytes and
    telemetry follows tree order, as in the JAX package."""
    W = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = flat_g[0].device
    plan = _plan(tuple(tuple(g.shape) for g in flat_g),
                 tuple(bool(s) for s in flat_s), comp)
    sel = select_and_encode(flat_g, flat_m, flat_s, eta, comp, plan)

    decoded = [None] * len(plan.leaves)
    if plan.total_words:
        payload = encode_buckets(plan, sel.enc_rows)
        check_bucket_payload(payload, plan, comp)
        decoded = decode_buckets(plan, gather_packed(payload, group))

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
    wire = np.float32(0.0)
    sums = TelemetrySums.zero(device)
    for lane, g, m in zip(plan.leaves, flat_g, flat_m):
        i = lane.index
        if lane.dense:
            acc = dense_acc[i]
            updates.append(dense_mean[i])
            new_mem.append(torch.zeros_like(m))
            nbytes = np.float32(acc.numel() * acc.element_size())
            wire = wire + nbytes
            sums = sums.add_dense(acc, g)
            continue
        g_vals, g_idx = decoded[i]
        (upd, mem_leaf, wire_add, resid_sq, own_sq,
         own_dot) = _consume_decoded_leaf(
            g, m, sel.g2f[i], g_vals, g_idx, lane.spec, lane.L, lane.d, W,
            rank, sel.use_fused, sel.sent[i], sel.resid[i], sel.acc2[i])
        updates.append(upd)
        new_mem.append(mem_leaf)
        wire = wire + wire_add
        sums = sums.add(g_sq=sel.leaf_g_sq[i], acc_sq=sel.leaf_acc_sq[i],
                        resid_sq=resid_sq, own_sq=own_sq, own_dot_g=own_dot)
    return updates, new_mem, wire, sums


def dense_aggregate(grads, eta, group=None):
    """Baseline: dense mean of eta*grad over the group (uncompressed
    wire); bytes are the f32 buffer the all-reduce moves."""
    device = tree_flatten(grads)[0][0].device
    eta = torch.as_tensor(eta, dtype=torch.float32).to(device)
    upd = tree_map(lambda g: all_reduce_mean(eta * g.float(), group), grads)
    wire = np.float32(sum(u.numel() * u.element_size()
                          for u in tree_flatten(upd)[0]))
    return upd, wire
