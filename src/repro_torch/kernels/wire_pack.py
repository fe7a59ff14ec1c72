"""Wrappers of the wire bit-packing CUDA kernels (``csrc/wire_pack.cu``).

Twins of ``src/repro/kernels/wire_pack.py``'s ``pack_words`` /
``unpack_words``, ragged ``counts``/``period`` variants included.  Fields
and words are uint32 bit patterns in int32 (or uint32) tensors.  Each
wrapper checks its tensors, launches on the current stream, raises on a
launch error and counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from . import _build

WORD_CHUNK = 512
_WORD_DTYPES = (torch.int32, torch.uint32)


def stream_shape(n_words: int) -> tuple[int, int]:
    """(rows, cols) reflow of a flat stream of ``n_words`` packed words
    into one launch; packing is word-local, so any row split of a
    word-aligned stream packs to the same words."""
    cols = min(WORD_CHUNK, max(n_words, 1))
    return -(-max(n_words, 1) // cols), cols


def _check(name: str, x: torch.Tensor, bits: int, counts, period: int):
    if x.device.type != "cuda" or x.dtype not in _WORD_DTYPES \
            or not x.is_contiguous() or x.dim() != 2:
        raise ValueError(f"{name}: want a contiguous 2-D int32/uint32 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if bits not in (4, 8, 16):
        raise ValueError(f"{name}: bits={bits} not in (4, 8, 16)")
    if counts is None:
        return None
    if period <= 0:
        raise ValueError(f"{name}: ragged variant needs a positive period")
    counts = counts.to(device=x.device, dtype=torch.int32).contiguous()
    if counts.numel() != x.shape[0]:
        raise ValueError(f"{name}: {counts.numel()} counts for "
                         f"{x.shape[0]} rows")
    return counts


def pack_words(fields: torch.Tensor, bits: int,
               counts: torch.Tensor | None = None,
               period: int = 0) -> torch.Tensor:
    """(R, n) fields -> (R, n*bits/32) int32 words; n % (32//bits) == 0."""
    counts = _check("pack_words", fields, bits, counts, period)
    F = 32 // bits
    R, n = fields.shape
    if n % F:
        raise ValueError(f"pack_words: {n} fields per row is not a "
                         f"multiple of {F}")
    out = torch.empty((R, n // F), dtype=torch.int32, device=fields.device)
    err = _build.load("wire_pack").pack_words_launch(
        fields.data_ptr(), 0 if counts is None else counts.data_ptr(),
        out.data_ptr(), R, n // F, bits, period, _build.stream(fields))
    _build.check(err, "pack_words")
    pack_words.launches += 1
    return out


pack_words.launches = 0


def unpack_words(words: torch.Tensor, bits: int,
                 counts: torch.Tensor | None = None,
                 period: int = 0) -> torch.Tensor:
    """(R, W) words -> (R, W*32/bits) int32 fields, zero past the count."""
    counts = _check("unpack_words", words, bits, counts, period)
    R, W = words.shape
    out = torch.empty((R, W * (32 // bits)), dtype=torch.int32,
                      device=words.device)
    err = _build.load("wire_pack").unpack_words_launch(
        words.data_ptr(), 0 if counts is None else counts.data_ptr(),
        out.data_ptr(), R, W, bits, period, _build.stream(words))
    _build.check(err, "unpack_words")
    unpack_words.launches += 1
    return out


unpack_words.launches = 0
