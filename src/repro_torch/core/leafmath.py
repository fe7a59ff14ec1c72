"""Per-leaf selection/encode math of the transports (twin of
``src/repro/core/leafmath.py``).

:func:`select_and_encode` is the whole-tree selection stage before the
gather: for block_topk ONE fused-EF two-pass launch pair over every
compressed leaf and the per-block selection of what it sent; for topk
the EF accumulation and an exact per-layer top-k; either way the
``(vals, idx, counts)`` rows that ``comm.bucket.encode_buckets``
consumes, with the round's valid counts of an adaptive compressor.
:func:`compress_leaf` is the selection of one leaf alone, without EF,
which the compressed downlink runs on the server's accumulator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm import wire as wire_fmt
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ef_acc
from .compression import Compressor, block_extract_sparse, \
    stable_topk_indices

f32 = np.float32


def per_layer_topk(acc2d: torch.Tensor, k: int):
    """Exact top-k over the last axis of (L, d), ties to the lower index."""
    idx = stable_topk_indices(acc2d.abs(), k)
    return torch.gather(acc2d, 1, idx), idx.to(torch.int32)


def jax_index_rules(vals: torch.Tensor, idx: torch.Tensor, d: int,
                    dtype=torch.float32):
    """Sparse pairs as JAX's ``dense.at[lidx, idx].add(vals)`` reads them:
    ``(vals as dtype, int64 indices in [0, d))``.  An index in ``[-d, 0)``
    wraps once to ``idx + d``; every other out-of-range one is dropped,
    written as -0.0 (the exact additive identity) at an in-range index,
    so none reaches the scatter (on CUDA it would fire a device-side
    assert).  A subnormal value is written as -0.0 too: XLA adds it as a
    zero (on the CPU and the TPU), torch would keep it; only a corrupted
    wire row carries one.  Works on the sparse pairs, never on a dense
    result."""
    vals = vals.to(dtype)
    idx = idx.to(torch.int64)
    kept = idx.clamp(-d, d - 1)
    drop = (kept != idx) | (vals.abs() < float(torch.finfo(dtype).tiny))
    return torch.where(drop, -0.0, vals), kept.remainder(d)


def scatter_pairs(vals: torch.Tensor, idx: torch.Tensor, L: int,
                  d: int) -> torch.Tensor:
    """Scatter-add (L, k) or (W, L, k) pairs that went through
    :func:`jax_index_rules` into a dense (L, d) accumulator of their
    dtype; the W axis sums into the same layer rows."""
    vals = vals.reshape(-1, L, vals.shape[-1])
    idx = idx.reshape(vals.shape)
    lidx = torch.arange(L, device=vals.device)[None, :, None].expand_as(idx)
    dense = torch.zeros((L, d), dtype=vals.dtype, device=vals.device)
    return dense.index_put_((lidx, idx), vals, accumulate=True)


def scatter_layers(vals: torch.Tensor, idx: torch.Tensor, L: int, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Scatter-add (L, k) or gathered (W, L, k) sparse pairs into a dense
    (L, d) accumulator under JAX's index rules (:func:`jax_index_rules`);
    the W axis sums into the same layer rows."""
    if vals.dim() not in (2, 3):
        raise ValueError(f"expected (L, k) or (W, L, k), got "
                         f"{tuple(vals.shape)}")
    return scatter_pairs(*jax_index_rules(vals, idx, d, dtype), L, d)


def leaf_2d(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """(L, d) per-layer view of a leaf (L = 1 when unstacked)."""
    if stacked and x.dim() >= 2:
        return x.reshape(x.shape[0], -1)
    return x.reshape(1, -1)


def compress_leaf(acc: torch.Tensor, comp: Compressor, stacked: bool):
    """Per-leaf sparse selection: ``(vals, idx, (L, d))``, the (L, k)
    wire pairs of the leaf's per-layer rows.  block_topk rows of at least
    ``min_compress_size`` take the exact per-block top-k_b, every other
    row the exact per-layer top-k; ties go to the lower index either
    way."""
    flat = leaf_2d(acc, stacked)
    L, d = flat.shape
    if comp.method == "block_topk" and d >= comp.min_compress_size:
        vals, idx = block_extract_sparse(flat, comp)
    else:
        vals, idx = per_layer_topk(flat, comp.k_for(d))
    return vals, idx, (L, d)


def leaf_count(comp: Compressor, spec, gamma_t, d: int) -> int | None:
    """The round's valid count of a leaf's rows: the per-block ``k_b_t``
    for block-local rows, the row ``k_t`` for flat rows; None unless the
    spec is ragged."""
    if not spec.ragged:
        return None
    return comp.block_k_t(gamma_t) if spec.local \
        else comp.k_t_for(d, gamma_t)


def plan_wire_bytes(plan, comp: Compressor, gamma_t=None):
    """(wire bytes, effective wire bytes) of one worker's exchange: the
    payload rows and the f32 dense leaves, and the same with each ragged
    row priced at its valid fields only (``WireSpec.effective_row_bytes``
    at the round's count).  f32 sums in tree order, as the JAX package's
    exchange accumulates them; the two agree unless the compressor is
    adaptive.  Host float32 scalars, from shapes alone."""
    wire = eff = f32(0.0)
    for ln in plan.leaves:
        if ln.dense:
            nbytes = f32(ln.L * ln.d * 4)
            wire, eff = wire + nbytes, eff + nbytes
            continue
        wire = wire + f32(ln.L * ln.spec.row_bytes)
        count = leaf_count(comp, ln.spec, gamma_t, ln.d)
        eff = eff + (f32(ln.L * ln.spec.row_bytes) if count is None else
                     f32(ln.L) * ln.spec.effective_row_bytes(count))
    return wire, eff


@dataclasses.dataclass
class Selection:
    """Whole-tree selection-stage outputs, indexed by leaf position
    (None where a field does not apply).  ``use_fused``: block_topk, whose
    leaves carry ``sent``/``resid`` from the fused EF kernels; topk leaves
    carry ``acc2`` instead."""

    use_fused: bool
    g2f: list
    acc2: list
    sent: list
    resid: list
    leaf_g_sq: list
    leaf_acc_sq: list
    enc_rows: list     # (vals, idx, counts or None) per compressed leaf


def select_and_encode(flat_g, flat_m, flat_s, eta: torch.Tensor,
                      comp: Compressor, gamma_t, plan) -> Selection:
    """``eta``: one f32 element on the working device.  Selection runs at
    the budget (``comp.geometry_gamma``): the fused EF passes threshold
    there, and the round's count masks the rest at encode time."""
    use_fused = comp.method == "block_topk"
    lanes = plan.leaves
    n = len(lanes)
    comp_ids = list(plan.compressed_ids)
    sel = Selection(use_fused, *([None] * n for _ in range(7)))
    if use_fused and comp_ids:
        ms = [leaf_2d(flat_m[i], flat_s[i]).float() for i in comp_ids]
        gs = [leaf_2d(flat_g[i], flat_s[i]).float() for i in comp_ids]
        outs = ops.fused_ef_compress_batched(ms, gs, eta,
                                             comp.geometry_gamma, comp.block)
        for i, g2, (s, r, _, moments) in zip(comp_ids, gs, outs):
            sel.g2f[i], sel.sent[i], sel.resid[i] = g2, s, r
            sel.leaf_g_sq[i] = moments[:, 0].sum()
            sel.leaf_acc_sq[i] = moments[:, 1].sum()
    for i in comp_ids:
        lane = lanes[i]
        if use_fused:
            vals, idx = block_extract_sparse(sel.sent[i], comp)
        else:
            g2 = leaf_2d(flat_g[i], flat_s[i]).float()
            a2 = ef_acc(leaf_2d(flat_m[i], flat_s[i]), g2, eta)
            sel.g2f[i], sel.acc2[i] = g2, a2
            sel.leaf_g_sq[i] = (g2 * g2).sum()
            sel.leaf_acc_sq[i] = (a2 * a2).sum()
            vals, idx = per_layer_topk(a2, comp.k_for(lane.d))
        count = leaf_count(comp, lane.spec, gamma_t, lane.d)
        sel.enc_rows[i] = (vals, idx, None if count is None else
                           wire_fmt.row_counts(count, lane.L, vals.device))
    return sel
