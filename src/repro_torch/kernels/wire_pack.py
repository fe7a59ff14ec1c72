"""Wrappers of the wire bit-packing CUDA kernels (``csrc/wire_pack.cu``).

Twins of ``src/repro/kernels/wire_pack.py``'s ``pack_words`` /
``unpack_words``, ragged ``counts``/``period`` variants included.  Fields
and words are uint32 bit patterns in int32 (or uint32) tensors.  Each
wrapper checks its tensors, launches on the current stream, raises on a
launch error and counts its launches in ``<wrapper>.launches``; the
ragged variants (``*_ragged``) count theirs apart.  The bucketed trainer
launches the plain kernels once or twice a step, so the host path reads each
tensor property once and looks the C entry point up once.
"""
from __future__ import annotations

import torch

from . import _build

WORD_CHUNK = 512
_WORD_DTYPES = (torch.int32, torch.uint32)
_FIELDS = {4: 8, 8: 4, 16: 2}          # bits -> fields a word
_ENTRIES: dict = {}                    # C launcher name -> its function


def stream_shape(n_words: int) -> tuple[int, int]:
    """(rows, cols) reflow of a flat stream of ``n_words`` packed words
    into one launch; packing is word-local, so any row split of a
    word-aligned stream packs to the same words."""
    cols = min(WORD_CHUNK, max(n_words, 1))
    return -(-max(n_words, 1) // cols), cols


def _launch(name: str, x: torch.Tensor, bits: int, counts, period: int,
            pack: bool) -> torch.Tensor:
    """Check ``x``, allocate the output, launch ``<name>_launch``."""
    shape, F = x.shape, _FIELDS.get(bits)
    if not x.is_cuda or x.dtype not in _WORD_DTYPES or len(shape) != 2 \
            or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 2-D int32/uint32 CUDA "
                         f"tensor, got {x.dtype} {tuple(shape)} on "
                         f"{x.device}")
    if F is None:
        raise ValueError(f"{name}: bits={bits} not in (4, 8, 16)")
    R, n = shape
    if pack and n % F:
        raise ValueError(f"{name}: {n} fields per row is not a multiple "
                         f"of {F}")
    dev = x.get_device()
    c_ptr = 0
    if counts is not None:
        if period <= 0:
            raise ValueError(f"{name}: ragged variant needs a positive "
                             "period")
        counts = counts.to(device=x.device, dtype=torch.int32).contiguous()
        if counts.numel() != R:
            raise ValueError(f"{name}: {counts.numel()} counts for {R} "
                             "rows")
        c_ptr = counts.data_ptr()
    W = n // F if pack else n
    out = torch.empty((R, W if pack else n * F), dtype=torch.int32,
                      device=dev)
    entry = _ENTRIES.get(name)
    if entry is None:
        entry = _ENTRIES[name] = getattr(_build.load("wire_pack"),
                                         f"{name}_launch")
    err = entry(x.data_ptr(), c_ptr, out.data_ptr(), R, W, bits, period,
                _build.raw_stream(dev))
    if err:
        _build.check(err, name)                    # raises
    return out


def pack_words(fields: torch.Tensor, bits: int,
               counts: torch.Tensor | None = None,
               period: int = 0) -> torch.Tensor:
    """(R, n) fields -> (R, n*bits/32) int32 words; n % (32//bits) == 0.
    With ``counts`` this is :func:`pack_words_ragged`."""
    if counts is not None:
        return pack_words_ragged(fields, bits, counts, period)
    out = _launch("pack_words", fields, bits, None, 0, True)
    pack_words.launches += 1
    return out


def pack_words_ragged(fields: torch.Tensor, bits: int,
                      counts: torch.Tensor, period: int) -> torch.Tensor:
    """The ragged variant: field j of row r is zeroed when ``j % period
    >= counts[r]``; launches are counted apart from the plain kernel's."""
    if counts is None:
        raise ValueError("pack_words_ragged: counts are required")
    out = _launch("pack_words", fields, bits, counts, period, True)
    pack_words_ragged.launches += 1
    return out


def unpack_words(words: torch.Tensor, bits: int,
                 counts: torch.Tensor | None = None,
                 period: int = 0) -> torch.Tensor:
    """(R, W) words -> (R, W*32/bits) int32 fields.  With ``counts`` this
    is :func:`unpack_words_ragged`."""
    if counts is not None:
        return unpack_words_ragged(words, bits, counts, period)
    out = _launch("unpack_words", words, bits, None, 0, False)
    unpack_words.launches += 1
    return out


def unpack_words_ragged(words: torch.Tensor, bits: int,
                        counts: torch.Tensor, period: int) -> torch.Tensor:
    """The ragged variant of :func:`unpack_words`: fields past each row's
    count come out zero."""
    if counts is None:
        raise ValueError("unpack_words_ragged: counts are required")
    out = _launch("unpack_words", words, bits, counts, period, False)
    unpack_words_ragged.launches += 1
    return out


pack_words.launches = 0
pack_words_ragged.launches = 0
unpack_words.launches = 0
unpack_words_ragged.launches = 0
