"""Chunked ring all-gather over the packed bucket buffer (twin of
``src/repro/comm/ring.py``, DESIGN.md §14).

``gather_packed`` (``comm/exchange.py``) moves the whole bucket buffer in
ONE ``all_gather_into_tensor``.  This module moves the same buffer as a
**ring schedule**: ``n_chunks`` word-aligned sections, each passed
send-right ``W-1`` times, so every worker ends with every worker's
payload.  It moves the same bytes per link as the flat gather
((W-1)/W of the gathered buffer) in ``n_chunks * (W-1)`` point-to-point
hops, and the result is bit for bit ``gather_packed``'s: the hops only
copy words, into rows in rank order.

Each hop of a chunk is a ``dist.P2POp`` send to rank ``(r+1) % W`` paired
with a receive from ``(r-1) % W`` of the same section; one ring step of
every chunk is one ``dist.batch_isend_irecv``.  The chunk that arrives at
step ``s`` came from rank ``step_source(r, s, W)`` and is written at that
row.  Step ``s+1`` forwards what step ``s`` received, so
:func:`ring_all_gather_start` posts step 1 and :meth:`RingGather.wait`
waits each step before it posts the next: with two workers every hop is
posted at the start.

The port's process group is one flat data-parallel axis, so only the
single-axis ring is ported, not JAX's ring of rings over mesh axes;
:func:`n_permutes` keeps JAX's signature and is called with ``(W,)``.

The scheduling pieces (:func:`chunk_table`, :func:`step_source`) are
shared with :func:`ring_gather_reference`, a NumPy simulator of the same
schedule, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "chunk_table",
    "step_source",
    "n_permutes",
    "RingGather",
    "ring_all_gather_start",
    "ring_all_gather",
    "ring_gather_reference",
]


def chunk_table(total_words: int,
                n_chunks: int) -> tuple[tuple[int, int], ...]:
    """Word-aligned ``(offset, length)`` sections covering
    ``[0, total_words)``.

    ``n_chunks`` is clamped to ``[1, total_words]`` (a chunk must hold at
    least one word); the first ``total_words % n`` chunks get one extra
    word, so non-divisible splits stay contiguous and exhaustive.
    """
    if total_words < 0:
        raise ValueError(f"total_words must be >= 0, got {total_words}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if total_words == 0:
        return ()
    n = min(n_chunks, total_words)
    base, rem = divmod(total_words, n)
    table = []
    off = 0
    for c in range(n):
        ln = base + (1 if c < rem else 0)
        table.append((off, ln))
        off += ln
    return tuple(table)


def step_source(i, s: int, size: int):
    """Origin worker of the chunk held by worker ``i`` after ring step ``s``.

    Send-right ring (``j -> (j+1) % size``): after ``s`` hops, worker
    ``i`` holds the chunk that started at ``(i - s) % size``.
    """
    return (i - s) % size


def n_permutes(axis_sizes: Sequence[int], total_words: int,
               n_chunks: int) -> int:
    """Exact number of send hops the ring posts (JAX: ``collective_permute``
    ops).

    Innermost axis first; each axis of size ``A > 1`` contributes
    ``chunks_eff * (A - 1)`` hops where ``chunks_eff`` is ``n_chunks``
    clamped to the block length at that stage.  The port's ring runs
    over one axis: call it with ``(W,)``.
    """
    total = 0
    words = total_words
    for size in reversed(tuple(axis_sizes)):
        if words > 0 and size > 1:
            total += len(chunk_table(words, n_chunks)) * (size - 1)
        words *= size
    return total


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


class RingGather:
    """A ring all-gather in flight; :meth:`wait` returns the
    ``(W, total_words)`` rows in rank order.  Nothing is posted at
    ``W == 1`` or for an empty payload."""

    def __init__(self, payload: torch.Tensor, group, n_chunks: int):
        self.group = group
        self.W = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        flat = payload.reshape(-1)
        self.out = torch.empty((self.W, flat.numel()), dtype=flat.dtype,
                               device=flat.device)
        # the own block lands at the own row; every remote block arrives
        # over the ring
        self.out[self.rank].copy_(flat)
        chunks = chunk_table(flat.numel(), n_chunks)   # validates n_chunks
        self.chunks = chunks if self.W > 1 else ()
        self.right = _global_rank(group, (self.rank + 1) % self.W)
        self.left = _global_rank(group, (self.rank - 1) % self.W)
        self.step = 0
        self.works: list = []
        if self.chunks:
            self._post(1)

    def _post(self, s: int) -> None:
        """Post ring step ``s`` of every chunk: send the section received
        at step ``s-1`` (the own one at step 1) right, receive the next
        from the left into row ``step_source(rank, s, W)``."""
        send_row = self.out[step_source(self.rank, s - 1, self.W)]
        recv_row = self.out[step_source(self.rank, s, self.W)]
        ops = []
        for c, (off, ln) in enumerate(self.chunks):
            ops.append(dist.P2POp(dist.isend, send_row[off:off + ln],
                                  self.right, self.group, tag=c))
            ops.append(dist.P2POp(dist.irecv, recv_row[off:off + ln],
                                  self.left, self.group, tag=c))
        self.works = dist.batch_isend_irecv(ops)
        self.step = s

    def wait(self) -> torch.Tensor:
        while self.works:
            for w in self.works:
                w.wait()
            self.works = []
            if self.step < self.W - 1:
                self._post(self.step + 1)
        return self.out


def ring_all_gather_start(payload: torch.Tensor, group=None,
                          n_chunks: int = 1) -> RingGather:
    """Post the ring's first step on ``payload`` (any shape, read flat) and
    return the gather in flight."""
    return RingGather(payload, group, n_chunks)


def ring_all_gather(payload: torch.Tensor, group=None,
                    n_chunks: int = 1) -> torch.Tensor:
    """Drop-in for ``gather_packed`` on a flat buffer: ``(total_words,)`` ->
    ``(W, total_words)``, rows in rank order, bit for bit; at ``W == 1``
    ``payload[None]`` with no hop."""
    return ring_all_gather_start(payload, group, n_chunks).wait()


def ring_gather_reference(bufs: np.ndarray, n_chunks: int) -> np.ndarray:
    """NumPy simulator of the single-axis ring schedule (no collectives).

    ``bufs``: ``(W, total_words)`` — worker ``w``'s payload in row ``w``.
    Simulates the exact send-right schedule (same ``chunk_table`` /
    ``step_source`` arithmetic as the collective path) and returns the
    per-worker assembled buffers, shape ``(W, W, total_words)``.  Raises
    if any (worker, row, word) slot is written twice or left unwritten.
    """
    bufs = np.asarray(bufs)
    W, total_words = bufs.shape
    out = np.zeros((W, W, total_words), dtype=bufs.dtype)
    written = np.zeros((W, W, total_words), dtype=np.int32)
    for w in range(W):  # own block, written up front like the ring
        out[w, w] = bufs[w]
        written[w, w] += 1
    for off, ln in chunk_table(total_words, n_chunks):
        hold = bufs[:, off:off + ln].copy()  # hold[w] = chunk at worker w
        for s in range(1, W):
            # send right: worker w's new buffer came from worker w-1
            hold = np.roll(hold, 1, axis=0)
            for w in range(W):
                src = step_source(w, s, W)
                out[w, src, off:off + ln] = hold[w]
                written[w, src, off:off + ln] += 1
    if total_words and W > 1 and not (written == 1).all():
        bad = int((written != 1).sum())
        raise AssertionError(
            f"ring schedule wrote {bad} slots != exactly once "
            f"(W={W}, n_chunks={n_chunks}, total_words={total_words})")
    return out
