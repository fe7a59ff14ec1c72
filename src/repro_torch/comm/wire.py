"""Bit-packed compressed-gradient wire format (twin of
``src/repro/comm/wire.py``, DESIGN.md §8–9): the row geometry, the
per-row codec of the ``perleaf`` transport (:func:`encode_rows`,
:func:`decode_rows`) and the field construction and interpretation that
the bucketed transport (``comm/bucket.py``) shares with it.

Row layout (uint32 words)::

    [ header | index section | value section ]

* header — word 0 iff the spec is ragged (an adaptive compressor): the
  row's valid count, per block (``k_b_t``) for block-local rows, per row
  (``k_t``) for flat rows; decode honours it whatever the tail fields
  hold.  Next, iff ``value_bits <= 8``: the f32 bits of the absmax scale.
* index section — k fields of ``index_bits``; block_topk rows store
  block-local 16-bit indices.
* value section — k fields of ``value_bits``: f32 bits (32), bfloat16 bits
  (16) or two's-complement absmax-scaled integers (8/4).

Fields and words are uint32 bit patterns carried in int32 tensors (see
``repro_torch/kernels/ref.py``).  Counts are (R,) int32 tensors.

:func:`roundtrip_rows` is ``decode_rows(encode_rows(...))`` without the
packed words: the compressed downlink (``comm/downlink.py``) decodes its
payload rows through it and launches no pack/unpack kernel, as the JAX
package's launches none.

:func:`row_verdict` and :func:`quarantine_rows` are the decode-side
guards of DESIGN.md §16: every transport's decode runs them unless
``comm.faults.guards_active()`` says otherwise (the default is on).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import to_u32_value

WORD_BYTES = 4
VALUE_BITS = (4, 8, 16, 32)


def _quant_helpers():
    # repro_torch.core imports this package: keep the import local
    from repro_torch.core.compression import QMAX, quant_scale
    return QMAX, quant_scale


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static description of one leaf row's packed payload."""

    k: int             # wire entries per row (k_max for ragged specs)
    d: int             # dense row length the indices address
    value_bits: int    # 4 | 8 | 16 | 32
    index_bits: int    # 16 | 32
    local: bool        # True: indices are block-local (block_topk rows)
    block: int = 0
    k_b: int = 0
    ragged: bool = False  # True: count header word, decode honours it

    def __post_init__(self):
        if self.value_bits not in VALUE_BITS:
            raise ValueError(f"unsupported value_bits {self.value_bits}")
        if self.index_bits not in (16, 32):
            raise ValueError(f"unsupported index_bits {self.index_bits}")
        if self.local and self.block > (1 << 16):
            raise ValueError("block-local 16-bit indices need block <= 2^16")

    @classmethod
    def for_row(cls, comp, d: int) -> "WireSpec | None":
        """Spec for one layer row of size d; None when it ships dense."""
        k = comp.sparse_k(d)
        if k >= d:
            return None
        ragged = comp.adaptive
        if comp.method == "block_topk":
            local = comp.block <= (1 << 16)
            if ragged and not local:
                # block_topk entries are sorted per block, so the valid
                # mask must be the per-block prefix (count_period = k_b),
                # which only block-local rows express
                raise ValueError(
                    "adaptive (max_gamma) block_topk needs block <= 2^16 "
                    "(block-local indices carry the per-block count mask)")
            return cls(k=k, d=d, value_bits=comp.value_bits,
                       index_bits=16 if local else 32, local=local,
                       block=comp.block, k_b=comp.block_k(), ragged=ragged)
        return cls(k=k, d=d, value_bits=comp.value_bits,
                   index_bits=16 if d <= (1 << 16) else 32, local=False,
                   ragged=ragged)

    @property
    def header_words(self) -> int:
        return (1 if self.ragged else 0) + (1 if self.value_bits <= 8 else 0)

    @property
    def count_period(self) -> int:
        """Field j of a row is valid iff ``j % count_period < count``: k_b
        for block-local rows (per-block prefix), k for flat rows."""
        return self.k_b if self.local else self.k

    @property
    def n_blocks(self) -> int:
        """Blocks per row (1 for flat rows)."""
        return self.k // self.k_b if self.local else 1

    @property
    def full_count(self) -> int:
        """The count that marks every entry valid."""
        return self.count_period

    def valid_entries(self, count: int) -> int:
        """Valid wire entries of a row at ``count``."""
        return count * self.n_blocks

    def effective_row_bytes(self, count: int) -> np.float32:
        """Bytes of one row if only its valid fields shipped (header and
        bit-packed valid fields, each section word-padded): what a ragged
        collective would move."""
        valid = self.valid_entries(count)
        iw = -(-valid * self.index_bits // 32)
        vw = -(-valid * self.value_bits // 32)
        return np.float32((self.header_words + iw + vw) * WORD_BYTES)

    @property
    def index_words(self) -> int:
        return -(-self.k * self.index_bits // 32)

    @property
    def value_words(self) -> int:
        return -(-self.k * self.value_bits // 32)

    @property
    def row_words(self) -> int:
        return self.header_words + self.index_words + self.value_words

    @property
    def row_bytes(self) -> int:
        return self.row_words * WORD_BYTES

    def local_base(self, device) -> torch.Tensor:
        """Flat-index base of each entry's block, (k,) int32."""
        return ((torch.arange(self.k, device=device) // self.k_b)
                * self.block).to(torch.int32)


def field_mask(k: int, counts: torch.Tensor, period: int) -> torch.Tensor:
    """(R, k) validity: field j of a row is valid iff ``j % period <
    counts[row]``."""
    pos = torch.arange(k, device=counts.device) % period
    return pos[None, :] < counts.reshape(-1, 1)


def row_counts(count: int, rows: int, device) -> torch.Tensor:
    """One round's count for each of ``rows`` rows, (rows,) int32."""
    return torch.full((rows,), count, dtype=torch.int32, device=device)


def row_fields(vals: torch.Tensor, idx: torch.Tensor, spec: WireSpec, *,
               counts: torch.Tensor | None = None):
    """Encode-side field construction: ``(header, ifields, vfields,
    counts)``, header the (R, header_words) columns (count, then scale;
    None without a header), the (R, k) unpacked field sections and the
    (R,) counts (None unless ragged; omitted counts mean all valid).
    Values beyond the count are zeroed before the scale; the field
    sections are not yet count-masked (the ragged pack kernels mask them,
    the bucketed path masks before its stream pack)."""
    R, k = vals.shape
    if k != spec.k:
        raise ValueError(f"{k} wire entries per row, spec says {spec.k}")
    vals = vals.float()
    header = []
    if spec.ragged:
        if counts is None:
            counts = row_counts(spec.full_count, R, vals.device)
        counts = counts.to(torch.int32).reshape(-1).expand(R)
        vals = torch.where(field_mask(k, counts, spec.count_period), vals,
                           0.0)
        header.append(counts[:, None])
    else:
        counts = None
    if spec.value_bits <= 8:
        QMAX, quant_scale = _quant_helpers()
        qmax = QMAX[spec.value_bits]
        scale = quant_scale(vals, qmax)                       # (R, 1) f32
        q = torch.clamp(torch.round(vals / scale), -qmax, qmax)
        vfields = q.to(torch.int32)          # two's complement, masked on pack
        header.append(scale.view(torch.int32))
    elif spec.value_bits == 16:
        vfields = vals.to(torch.bfloat16).view(torch.int16).to(
            torch.int32) & 0xFFFF
    else:
        vfields = vals.view(torch.int32)

    if spec.local:
        ifields = idx.to(torch.int32) - spec.local_base(idx.device)[None, :]
    else:
        ifields = idx.to(torch.int32)
    header = torch.cat(header, dim=-1) if header else None
    return header, ifields, vfields, counts


def encode_rows(vals: torch.Tensor, idx: torch.Tensor, spec: WireSpec, *,
                counts: torch.Tensor | None = None) -> torch.Tensor:
    """Encode (R, k) f32 values and (R, k) int32 flat indices into the
    packed (R, row_words) int32 payload, one pack launch per section (the
    ragged kernels for a ragged spec: they zero the fields past each
    row's count)."""
    R = vals.shape[0]
    header, ifields, vfields, counts = row_fields(vals, idx, spec,
                                                  counts=counts)
    period = spec.count_period if spec.ragged else 0
    parts = [header] if header is not None else []
    parts.append(ops.pack_fields(ifields, spec.index_bits, counts=counts,
                                 period=period))
    parts.append(ops.pack_fields(vfields, spec.value_bits, counts=counts,
                                 period=period))
    payload = torch.cat(parts, dim=-1)
    if tuple(payload.shape) != (R, spec.row_words):
        raise ValueError(f"encoded payload {tuple(payload.shape)}, spec "
                         f"says ({R}, {spec.row_words})")
    return payload


def fields_to_rows(ifields: torch.Tensor, vfields: torch.Tensor,
                   scale_words: torch.Tensor | None,
                   counts: torch.Tensor | None, spec: WireSpec):
    """Decode-side field interpretation: (R, k) unpacked sections (already
    count-masked for ragged specs) -> ((R, k) f32 values, (R, k) int32
    flat indices)."""
    if spec.local:
        idx = ifields + spec.local_base(ifields.device)[None, :]
    else:
        idx = ifields
    if spec.value_bits <= 8:
        scale = scale_words.contiguous().view(torch.float32)
        # XLA reads a subnormal operand as a signed zero (the JAX
        # package's decode on the CPU and the TPU); torch keeps it.  Only
        # a corrupted row carries such a scale: flush it, so that the
        # decode of any row is JAX's (|q| >= 1 keeps every product normal)
        scale = torch.where(scale.abs() < float(np.finfo(np.float32).tiny),
                            scale * 0.0, scale)
        q = to_u32_value(vfields)
        q = torch.where(q >= (1 << (spec.value_bits - 1)),
                        q - (1 << spec.value_bits), q)
        vals = q.float() * scale
    elif spec.value_bits == 16:
        v = to_u32_value(vfields) & 0xFFFF
        v = torch.where(v >= (1 << 15), v - (1 << 16), v)
        vals = v.to(torch.int16).view(torch.bfloat16).float()
    else:
        vals = vfields.contiguous().view(torch.float32)
    if spec.ragged:
        # as in the JAX package, on top of the unpack mask: masked fields
        # decode to 0.0 already (zero bits are 0 in every value format)
        vals = torch.where(field_mask(spec.k, counts, spec.count_period),
                           vals, 0.0)
    return vals, idx


def decode_rows(payload: torch.Tensor, spec: WireSpec):
    """Decode a packed (R, row_words) payload to ((R, k) f32 values,
    (R, k) int32 flat indices).  A ragged row is read at the count in its
    own header word (rows from different workers may carry different
    counts): fields past it come back as value 0 at the block's base."""
    R, words = payload.shape
    if words != spec.row_words:
        raise ValueError(f"payload rows of {words} words, spec says "
                         f"{spec.row_words}")
    off = spec.header_words
    counts, period = None, 0
    if spec.ragged:
        counts, period = payload[:, 0].contiguous(), spec.count_period
    iw, vw = spec.index_words, spec.value_words
    ifields = ops.unpack_fields(payload[:, off:off + iw], spec.k,
                                spec.index_bits, counts=counts,
                                period=period)
    vfields = ops.unpack_fields(payload[:, off + iw:off + iw + vw], spec.k,
                                spec.value_bits, counts=counts,
                                period=period)
    scale_words = payload[:, off - 1:off] if spec.value_bits <= 8 else None
    return fields_to_rows(ifields, vfields, scale_words, counts, spec)


def roundtrip_rows(vals: torch.Tensor, idx: torch.Tensor, spec: WireSpec, *,
                   counts: torch.Tensor | None = None):
    """``decode_rows(encode_rows(vals, idx, ...))`` without packed words:
    :func:`row_fields` composed with :func:`fields_to_rows`, bit for bit
    the literal round trip and no kernel launch.  A packed field keeps the
    low ``value_bits`` / ``index_bits`` of its int32 field, so the
    quantized fields (two's complement in int32) are cut to their low
    bits here, as the pack cuts them; ``fields_to_rows`` folds them back
    to signed values.  On a ragged spec the fields past each row's count
    are zeroed first, as the ragged pack kernels zero them, so a masked
    entry decodes to value 0 at its block's base index."""
    header, ifields, vfields, counts = row_fields(vals, idx, spec,
                                                  counts=counts)
    if spec.value_bits <= 8:
        vfields = vfields & ((1 << spec.value_bits) - 1)
    if spec.ragged:
        m = field_mask(spec.k, counts, spec.count_period)
        ifields = torch.where(m, ifields, 0)
        vfields = torch.where(m, vfields, 0)
    scale_words = header[:, -1:] if spec.value_bits <= 8 else None
    return fields_to_rows(ifields, vfields, scale_words, counts, spec)


def row_verdict(payload: torch.Tensor, spec: WireSpec, vals: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Per-row validity of a decoded payload: (R,) bool, True iff the row
    is safe to aggregate (the JAX package's rules):

    * every element's index is in ``[0, d)`` or its value is 0 (padding
      and masked entries hold clamped or zero indices);
    * 16- and 32-bit values are all finite;
    * a ragged row's count header is in ``[0, full_count]``;
    * an 8- or 4-bit row's scale word satisfies ``|scale| <= f32_max /
      2^(bits-1)``, which rejects NaN/Inf scales and finite ones whose
      dequantized values would overflow (the values are then finite).

    Honest encodes pass every rule, so the verdict is all True on a clean
    wire.  The element rules form one boolean per element, reduced once
    per row."""
    ok_elems = ((idx >= 0) & (idx < spec.d)) | (vals == 0.0)
    if spec.value_bits > 8:
        ok_elems &= torch.isfinite(vals)
    ok = ok_elems.all(dim=-1)
    if spec.ragged:
        counts = payload[:, 0]
        ok &= (counts >= 0) & (counts <= spec.full_count)
    if spec.value_bits <= 8:
        scale = payload[:, spec.header_words - 1].contiguous().view(
            torch.float32)
        q_max = float(1 << (spec.value_bits - 1))
        ok &= scale.abs() <= float(np.finfo(np.float32).max) / q_max
    return ok


def quarantine_rows(vals: torch.Tensor, idx: torch.Tensor,
                    verdict: torch.Tensor):
    """An invalid row becomes value 0.0 at index 0 in every entry, so it
    scatters nothing; a valid row passes through untouched (harmless
    out-of-range padding indices included).  The caller divides by the
    valid-row count the verdict gives."""
    keep = verdict[:, None]
    return (torch.where(keep, vals, 0.0),
            torch.where(keep, idx, torch.zeros((), dtype=idx.dtype,
                                               device=idx.device)))
