"""Bit-packed compressed-gradient wire format (twin of
``src/repro/comm/wire.py``, DESIGN.md §8): the row geometry, the
encode-side field construction and the decode-side field interpretation
that the bucketed transport (``comm/bucket.py``) shares.

Row layout (uint32 words)::

    [ header | index section | value section ]

* header — one word iff ``value_bits <= 8``: the f32 bits of the absmax
  scale.
* index section — k fields of ``index_bits``; block_topk rows store
  block-local 16-bit indices.
* value section — k fields of ``value_bits``: f32 bits (32), bfloat16 bits
  (16) or two's-complement absmax-scaled integers (8/4).

Fields and words are uint32 bit patterns carried in int32 tensors (see
``repro_torch/kernels/ref.py``).
"""
from __future__ import annotations

import dataclasses

import torch

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

    k: int             # wire entries per row
    d: int             # dense row length the indices address
    value_bits: int    # 4 | 8 | 16 | 32
    index_bits: int    # 16 | 32
    local: bool        # True: indices are block-local (block_topk rows)
    block: int = 0
    k_b: int = 0

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
        if comp.method == "block_topk":
            local = comp.block <= (1 << 16)
            return cls(k=k, d=d, value_bits=comp.value_bits,
                       index_bits=16 if local else 32, local=local,
                       block=comp.block, k_b=comp.block_k())
        return cls(k=k, d=d, value_bits=comp.value_bits,
                   index_bits=16 if d <= (1 << 16) else 32, local=False)

    @property
    def header_words(self) -> int:
        return 1 if self.value_bits <= 8 else 0

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


def row_fields(vals: torch.Tensor, idx: torch.Tensor, spec: WireSpec):
    """Encode-side field construction: ``(header, ifields, vfields)``
    with header the (R, header_words) columns (or None) and the (R, k)
    unpacked field sections."""
    k = vals.shape[1]
    if k != spec.k:
        raise ValueError(f"{k} wire entries per row, spec says {spec.k}")
    vals = vals.float()
    header = None
    if spec.value_bits <= 8:
        QMAX, quant_scale = _quant_helpers()
        qmax = QMAX[spec.value_bits]
        scale = quant_scale(vals, qmax)                       # (R, 1) f32
        q = torch.clamp(torch.round(vals / scale), -qmax, qmax)
        vfields = q.to(torch.int32)          # two's complement, masked on pack
        header = scale.view(torch.int32)
    elif spec.value_bits == 16:
        vfields = vals.to(torch.bfloat16).view(torch.int16).to(
            torch.int32) & 0xFFFF
    else:
        vfields = vals.view(torch.int32)

    if spec.local:
        ifields = idx.to(torch.int32) - spec.local_base(idx.device)[None, :]
    else:
        ifields = idx.to(torch.int32)
    return header, ifields, vfields


def fields_to_rows(ifields: torch.Tensor, vfields: torch.Tensor,
                   scale_words: torch.Tensor | None, spec: WireSpec):
    """Decode-side field interpretation: (R, k) unpacked sections ->
    ((R, k) f32 values, (R, k) int32 flat indices)."""
    if spec.local:
        idx = ifields + spec.local_base(ifields.device)[None, :]
    else:
        idx = ifields
    if spec.value_bits <= 8:
        scale = scale_words.contiguous().view(torch.float32)
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
    return vals, idx
