"""The chunked ring all-gather (``comm/ring.py``) against the JAX package
and against the port's flat gather.

The scheduling pieces — ``chunk_table``, ``step_source``, ``n_permutes``
and the NumPy simulator ``ring_gather_reference`` — equal JAX's on a grid
that includes fewer words than chunks and an empty buffer, errors word
for word.  ``ring_all_gather`` over 2, 3 and 4 gloo workers equals
``gather_packed`` bit for bit at 1, 3 and 7 chunks, on a plain and a
ragged bucket payload, and posts exactly ``n_permutes((W,), ...)`` send
hops; on one worker it posts none.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm import ring as jring
from repro_torch.comm import exchange, ring

import torch_overlap_workers as workers

torch.set_num_threads(2)

CHUNKS = (1, 3, 7)


@pytest.mark.parametrize("words", [0, 1, 2, 5, 6, 7, 100, 1001])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 7, 64])
def test_chunk_table_matches_jax(words, n_chunks):
    got = ring.chunk_table(words, n_chunks)
    assert got == jring.chunk_table(words, n_chunks)
    assert sum(ln for _, ln in got) == words
    assert len(got) == min(n_chunks, words)


@pytest.mark.parametrize("args", [(-1, 2), (5, 0), (0, -3)])
def test_chunk_table_errors_match_jax(args):
    with pytest.raises(ValueError) as e:
        jring.chunk_table(*args)
    with pytest.raises(ValueError) as t:
        ring.chunk_table(*args)
    assert str(t.value) == str(e.value)


def test_step_source_and_n_permutes_match_jax():
    for size in (1, 2, 3, 4, 8):
        for i in range(size):
            for s in range(size + 2):
                assert ring.step_source(i, s, size) == \
                    jring.step_source(i, s, size)
    for axes in ((1,), (2,), (3,), (4,), (8,), (4, 2), (2, 1, 3)):
        for words in (0, 1, 3, 7, 1000):
            for nc in (1, 3, 7, 2000):
                assert ring.n_permutes(axes, words, nc) == \
                    jring.n_permutes(axes, words, nc), (axes, words, nc)


@pytest.mark.parametrize("W,words,n_chunks", [
    (1, 10, 3), (2, 0, 3), (2, 5, 7), (3, 1000, 3), (4, 999, 7), (4, 3, 1)])
def test_ring_gather_reference_matches_jax(W, words, n_chunks):
    bufs = np.random.default_rng(W * 100 + words).integers(
        0, 2**32, (W, words), dtype=np.uint32)
    got = ring.ring_gather_reference(bufs, n_chunks)
    np.testing.assert_array_equal(got, jring.ring_gather_reference(
        bufs, n_chunks))
    # every worker assembles every worker's payload in rank order
    np.testing.assert_array_equal(got, np.broadcast_to(bufs,
                                                       (W,) + bufs.shape))


@pytest.mark.parametrize("W", [2, 3, 4])
def test_ring_all_gather_equals_gather_packed(W):
    got = workers.spawn(workers.ring_gathers, W, CHUNKS)
    for rank in range(W):
        assert len(got[rank]) == 2 * len(CHUNKS)
        for adaptive, nc, equal, shape, sends, words in got[rank]:
            assert equal, (rank, adaptive, nc)
            assert shape == (W, words)
            assert sends == ring.n_permutes((W,), words, nc) \
                == min(nc, words) * (W - 1), (rank, adaptive, nc)


def test_one_worker_posts_nothing():
    created = exchange.init_process_group(torch.device("cpu"))
    real = dist.batch_isend_irecv
    calls = []
    dist.batch_isend_irecv = lambda ops: calls.append(ops)  # noqa: E731
    try:
        payload = workers.ring_payload(0, True)
        for nc in CHUNKS:
            got = ring.ring_all_gather(payload, None, nc)
            assert torch.equal(got, payload[None])
            assert got.data_ptr() != payload.data_ptr()
        assert ring.ring_all_gather(payload[:0]).shape == (1, 0)
        with pytest.raises(ValueError, match="n_chunks must be >= 1"):
            ring.ring_all_gather_start(payload, None, 0)
    finally:
        dist.batch_isend_irecv = real
        if created:
            dist.destroy_process_group()
    assert calls == []
