"""Gradient compression operators (twin of ``src/repro/core/compression.py``).

Compression is per leaf (per layer row on the distributed path); leaves
under ``min_compress_size`` parameters ship uncompressed; ``gamma = k/d``.

* ``topk``       — exact magnitude top-k.
* ``block_topk`` — per 1024-wide block top-k_b through the hand-written
                   kernels (``repro_torch/kernels``): the fused EF passes
                   on the distributed path, ``block_stats`` +
                   ``threshold_split`` in :meth:`Compressor.compress_dense`.

Ties are broken toward the lower index, as ``lax.top_k`` does: selection
uses a stable descending sort, because ``torch.topk`` leaves the order of
equal values unspecified and the shipped indices must match the JAX
package's bit for bit.

``max_gamma > 0`` makes the compressor adaptive: every static size (the
payload rows, ``wire_bytes``) is the budget's, and a round compresses at
its own ``gamma_t <= max_gamma``, keeping the per-round ``k_t`` (or the
per-block ``k_b_t``) of the budget's magnitude-sorted entries; the
effective-byte functions price what a ragged collective would ship.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F_

from repro_torch.kernels import ops
from repro_torch.utils import tree_leaves

#: Leaves smaller than this are not compressed (paper §IV-A).
MIN_COMPRESS_SIZE = 1000

#: Integer quantization range per sub-byte/byte value width (symmetric).
QMAX = {8: 127.0, 4: 7.0}


def quant_scale(vals: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-row absmax quantization scale, max|row| / qmax + 1e-30, as the
    jitted JAX package computes it: XLA turns the division into a
    multiplication by the f32 reciprocal and fuses the add into it, one
    rounding in all.  A true division differs in the last bit for about
    half the rows, a separate multiply and add on exact midpoints."""
    amax = vals.abs().amax(dim=-1, keepdim=True)
    recip = float(np.float32(1.0) / np.float32(qmax))
    return torch.addcmul(torch.full_like(amax, 1e-30), amax,
                         torch.full_like(amax, recip))


def stable_topk_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, largest
    first and the lower index first among equals (``lax.top_k``'s order)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[
        ..., :k]


@dataclasses.dataclass(frozen=True)
class Sparse:
    """A compressed tensor: flat values + flat int32 indices into the leaf
    of shape ``shape``."""

    values: torch.Tensor    # (k,)
    indices: torch.Tensor   # (k,) int32
    shape: tuple


def topk_select(x: torch.Tensor, k: int) -> Sparse:
    """Exact magnitude top-k of the flattened x, largest first and the
    lower index first among equals."""
    flat = x.reshape(-1)
    if k >= flat.numel():
        return Sparse(flat, torch.arange(flat.numel(), dtype=torch.int32,
                                         device=x.device), tuple(x.shape))
    idx = stable_topk_indices(flat.abs(), k)
    return Sparse(flat[idx], idx.to(torch.int32), tuple(x.shape))


def sparse_to_dense(s: Sparse, dtype=None) -> torch.Tensor:
    """Scatter-add a Sparse back to a dense tensor of its shape."""
    vals = s.values.reshape(-1)
    dense = torch.zeros(int(np.prod(s.shape)), dtype=dtype or vals.dtype,
                        device=vals.device)
    dense.index_add_(0, s.indices.reshape(-1).to(torch.int64),
                     vals.to(dense.dtype))
    return dense.reshape(s.shape)


def block_extract_sparse(x2d: torch.Tensor, comp: "Compressor"):
    """Wire pairs via exact per-block top-k_b.  x2d: (L, d) per-layer rows;
    blocks never span layers.  Returns (vals, idx), each (L, nb*k_b), idx
    flat into [0, d) (clamped: padding positions carry zero values)."""
    L, d = x2d.shape
    block = comp.block
    pad = (-d) % block
    blocks = (F_.pad(x2d, (0, pad)) if pad else x2d).reshape(L, -1, block)
    nb = blocks.shape[1]
    bidx = stable_topk_indices(blocks.abs(), comp.block_k())
    base = (torch.arange(nb, device=x2d.device) * block)[None, :, None]
    idx = (bidx + base).reshape(L, -1).clamp_max(d - 1).to(torch.int32)
    vals = torch.gather(blocks, 2, bidx).reshape(L, -1)
    return vals, idx


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Per-leaf compression policy; ``gamma`` is the paper's k/d.

    ``value_bits`` (32|16|8|4): wire value width of the packed payload
    (``repro_torch/comm/wire.py``).  ``block_topk`` always runs through
    the fused EF kernels.

    ``max_gamma`` > 0: the adaptive budget.  Payload rows, ``wire_bytes``
    and the EF threshold are sized for ``max_gamma``; a round passes its
    own ``gamma_t`` and entries ranked beyond ``k_t`` are masked behind
    the row's count header.  ``gamma`` stays the initial ratio."""

    gamma: float = 0.01
    method: str = "topk"            # topk | block_topk | none
    block: int = 1024
    min_compress_size: int = MIN_COMPRESS_SIZE
    value_bits: int = 32
    max_gamma: float = 0.0          # > 0: adaptive budget

    def __post_init__(self):
        if self.method not in ("topk", "block_topk", "none"):
            raise ValueError(f"unknown compression method {self.method!r}")

    @property
    def adaptive(self) -> bool:
        """True when the wire rows carry per-round valid counts."""
        return self.max_gamma > 0.0

    @property
    def geometry_gamma(self) -> float:
        """The gamma every static size is built for (the budget)."""
        return self.max_gamma if self.adaptive else self.gamma

    def k_for(self, d: int) -> int:
        if self.method == "none" or d < self.min_compress_size:
            return d
        return max(1, int(round(self.geometry_gamma * d)))

    def block_k(self) -> int:
        """k_b: entries kept per ``block``-wide block (block_topk)."""
        return max(1, int(round(self.geometry_gamma * self.block)))

    def k_t_for(self, d: int, gamma_t) -> int:
        """Per-round k_t of a flat row of size d: round(gamma_t * d) in
        f32, half to even, clamped into [1, k_for(d)]."""
        return _round_clip(gamma_t, d, self.k_for(d))

    def block_k_t(self, gamma_t) -> int:
        """Per-round valid count of each block, in [1, block_k()]."""
        return _round_clip(gamma_t, self.block, self.block_k())

    def sparse_k(self, d: int) -> int:
        """(value, index) pairs on the wire for a row of size d."""
        k = self.k_for(d)
        if k == d:
            return d
        if self.method == "block_topk":
            return -(-d // self.block) * self.block_k()
        return k

    def ships_dense(self, d: int) -> bool:
        """THE dense-vs-compressed predicate of a row of size d."""
        return (self.method == "none" or d < self.min_compress_size
                or self.sparse_k(d) >= d)

    def quantize_values(self, vals: torch.Tensor) -> torch.Tensor:
        """Wire quantization of the values as receivers reconstruct them
        (dequantized, vals' dtype); the scale is per row of the leading
        dims, computed as :func:`quant_scale`."""
        if self.value_bits >= 32:
            return vals
        if self.value_bits == 16:
            return vals.to(torch.bfloat16).to(vals.dtype)
        qmax = QMAX[self.value_bits]
        scale = quant_scale(vals, qmax)
        q = torch.clamp(torch.round(vals / scale), -qmax, qmax)
        return (q * scale).to(vals.dtype)

    def compress_dense(self, x: torch.Tensor, gamma_t=None):
        """(top_k(x) as a dense tensor, residual x - top_k(x)) of one leaf,
        flattened whole (single-node semantics).  ``block_topk`` runs the
        ``block_stats`` and ``threshold_split`` kernels over the flat
        leaf's 1024-wide blocks and ships values unquantized; ``topk``
        quantizes its values when ``value_bits < 32``.  ``gamma_t``
        (adaptive compressors): the round's ratio, see
        :meth:`_compress_dense_ragged`."""
        d = x.numel()
        if self.method == "none" or d < self.min_compress_size:
            return x, torch.zeros_like(x)
        if gamma_t is not None and self.adaptive:
            return self._compress_dense_ragged(x, gamma_t)
        if self.method == "block_topk":
            flat = x.reshape(-1)
            tau = ops.block_topk_threshold(flat, self.block_k(), self.block)
            sent, resid = ops.threshold_split_blocks(
                flat, tau.reshape(-1, 1), self.block)
            return sent.reshape(x.shape), resid.reshape(x.shape)
        s = topk_select(x, self.k_for(d))
        if self.value_bits < 32:
            s = Sparse(self.quantize_values(s.values), s.indices, s.shape)
        dense = sparse_to_dense(s, x.dtype)
        return dense, x - dense

    def _compress_dense_ragged(self, x: torch.Tensor, gamma_t):
        """Selection at the budget, masked to the round's count: the
        candidates come largest first (per block for ``block_topk``), so
        the first k_t of them are the round's top k_t, and the masked
        ones fall into the residual.  Plain PyTorch on every device, as
        the JAX package's ragged path is plain jnp."""
        d = x.numel()
        flat = x.reshape(-1)
        if self.method == "topk":
            idx = stable_topk_indices(flat.abs(), self.k_for(d))
            pos = torch.arange(idx.numel(), device=x.device)
            vals = torch.where(pos < self.k_t_for(d, gamma_t), flat[idx],
                               0.0)
            if self.value_bits < 32:
                vals = self.quantize_values(vals)    # scale of valid only
            dense = sparse_to_dense(
                Sparse(vals, idx.to(torch.int32), tuple(x.shape)), x.dtype)
        else:
            vals, idx = block_extract_sparse(flat.reshape(1, -1), self)
            pos = torch.arange(vals.shape[-1], device=x.device)
            vals = torch.where(pos % self.block_k() < self.block_k_t(gamma_t),
                               vals, 0.0)
            dense = sparse_to_dense(Sparse(vals.float(), idx,
                                           tuple(x.shape))).to(x.dtype)
        return dense, x - dense

    def wire_bytes(self, x_size: int, itemsize: int = 4) -> int:
        """Bytes on the wire for one leaf row: the packed payload row, or
        the dense row for uncompressed leaves."""
        if self.sparse_k(x_size) >= x_size:
            return x_size * itemsize
        from repro_torch.comm.wire import WireSpec  # local import: no cycle
        return WireSpec.for_row(self, x_size).row_bytes

    def leaf_wire_bytes(self, shape, itemsize: int = 4) -> int:
        """Wire bytes for one leaf; ndim >= 2 leaves are compressed per
        layer (leading axis)."""
        L, d = leaf_geometry(shape)
        return L * self.wire_bytes(d, itemsize)


def leaf_geometry(shape) -> tuple[int, int]:
    """(L, d) per-layer view of a leaf shape (ndim >= 2: leading axis =
    layers)."""
    shape = tuple(shape)
    if len(shape) >= 2:
        return shape[0], int(np.prod(shape[1:]))
    return 1, (shape[0] if shape else 1)


def tree_wire_bytes(tree, comp: Compressor, itemsize: int = 4) -> int:
    """Communicated bytes per worker per step for a gradient tree."""
    return sum(comp.leaf_wire_bytes(leaf.shape, itemsize)
               for leaf in tree_leaves(tree))


def _round_clip(gamma_t, n: int, hi: int) -> int:
    """clip(round(f32(gamma_t) * n), 1, hi): the product in f32 and
    rounded half to even, as the JAX package's ``jnp.round`` computes it;
    the count is a host int, as gamma_t is a host scalar."""
    t = np.round(np.float32(gamma_t) * np.float32(n))
    return int(min(max(t, 1), hi))


def leaf_effective_wire_bytes(comp: Compressor, shape, gamma_t,
                              itemsize: int = 4) -> np.float32:
    """Per-round useful wire bytes of one leaf at ``gamma_t``: the header
    and only the valid (index, value) fields, bit-packed.  Equals
    :meth:`Compressor.leaf_wire_bytes` for non-adaptive compressors.
    Leaves with ndim >= 2 are read as stacked, as :func:`leaf_geometry`
    reads them; the exchange's own figure uses the model's stacked mask
    (``core.leafmath.plan_wire_bytes``)."""
    L, d = leaf_geometry(shape)
    if comp.sparse_k(d) >= d:
        return np.float32(L * d * itemsize)
    from repro_torch.comm.wire import WireSpec  # local import: no cycle
    spec = WireSpec.for_row(comp, d)
    if not spec.ragged:
        return np.float32(L * spec.row_bytes)
    count = comp.block_k_t(gamma_t) if spec.local \
        else comp.k_t_for(d, gamma_t)
    return np.float32(L) * spec.effective_row_bytes(count)


def tree_effective_wire_bytes(tree, comp: Compressor, gamma_t,
                              itemsize: int = 4) -> np.float32:
    """Per-round effective bytes of a tree (f32 sum in tree order); the
    runtime counterpart of :func:`tree_wire_bytes`, the static bound."""
    total = np.float32(0.0)
    for leaf in tree_leaves(tree):
        total = total + leaf_effective_wire_bytes(comp, leaf.shape, gamma_t,
                                                  itemsize)
    return total
