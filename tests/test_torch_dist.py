"""The bucketed exchange across two worker processes (gloo on the CPU).

Each worker all-gathers the packed payload, decodes both rows and takes
the mean; its EF memory comes from its own decoded row.  So with two
workers the update must equal the mean of the two single-worker updates
and each worker's memory its single-worker memory, bit for bit: f32
addition of two values is commutative, the halving is exact, and a
single-worker update is exactly that worker's decoded payload.  This pins
the rank order of the gather, the own-row slice and the dense all-reduce.

With an adaptive compressor the two workers compress at different
gamma_t, so their rows carry different counts: each decodes the other's
rows at the sender's count, on both transports.

Two workers through the trainer's CLI save their own state under
``rank_<r>``; resumed, they equal an uninterrupted two-worker run bit for
bit, and another world size cannot resume their checkpoints.
"""
import multiprocessing as mp
import os
import socket

import pytest

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import exchange
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate

torch.set_num_threads(2)

COMP = dict(gamma=0.05, method="block_topk", block=512, min_compress_size=64,
            value_bits=8)
ETA = np.float32(0.7)


def _inputs(rank):
    rng = np.random.default_rng(10 + rank)
    tree = {"a": rng.standard_normal((3, 2048)).astype(np.float32),
            "b": rng.standard_normal((3000,)).astype(np.float32),
            "tiny": rng.standard_normal((50,)).astype(np.float32)}
    mem = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in tree.items()}
    return tree, mem


#: the adaptive case: a 10% budget, worker r at ADAPTIVE_GAMMA[r]
ADAPTIVE = dict(gamma=0.01, max_gamma=0.1, method="block_topk",
                min_compress_size=64, value_bits=8)
ADAPTIVE_GAMMA = (np.float32(0.02), np.float32(0.07))


def _exchange(rank, adaptive=False, transport="bucketed"):
    tree, mem = _inputs(rank)
    comp = Compressor(**(ADAPTIVE if adaptive else COMP))
    upd, new_mem, wire, eff, _ = worker_compress_aggregate(
        to_torch(tree), to_torch(mem), ETA, comp,
        gamma_t=ADAPTIVE_GAMMA[rank] if adaptive else None,
        transport=transport)
    return to_numpy(upd), to_numpy(new_mem), float(wire), float(eff)


def _worker(rank, port, queue, adaptive, transport):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        queue.put((rank, _exchange(rank, adaptive, transport)))
    finally:
        dist.destroy_process_group()


def _two_workers_against_singles(adaptive, transport):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, port, queue, adaptive, transport))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0

    created = exchange.init_process_group(torch.device("cpu"))
    try:
        single = [_exchange(r, adaptive, transport) for r in range(2)]
    finally:
        if created:
            dist.destroy_process_group()
    for rank in range(2):
        upd, mem, wire, eff = got[rank]
        for k in upd:
            want = (single[0][0][k] + single[1][0][k]) / np.float32(2)
            np.testing.assert_array_equal(upd[k], want, err_msg=k)
            np.testing.assert_array_equal(mem[k], single[rank][1][k],
                                          err_msg=k)
        assert (wire, eff) == single[rank][2:]
    return got


def test_two_workers_mean_of_single_worker_exchanges():
    _two_workers_against_singles(False, "bucketed")


@pytest.mark.parametrize("transport", ["perleaf", "bucketed"])
def test_two_workers_at_different_gamma_t(transport):
    """Worker 0 sends k_b_t 20, worker 1 k_b_t 72 of a budget of 102 a
    block: the same static bytes, fewer effective bytes for worker 0."""
    got = _two_workers_against_singles(True, transport)
    assert got[0][2] == got[1][2]
    assert got[0][3] < got[1][3] < got[0][2]


# ---------------------------------------------------------------------------
# checkpoints of two workers: save, resume, and another world size
# ---------------------------------------------------------------------------

SMOKE = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
         "4", "--compress-method", "block_topk", "--log-every", "1"]


def _final_arrays(d, rank):
    from repro_torch.checkpoint import checkpoint as ckpt
    d = os.path.join(d, f"rank_{rank:03d}")
    z = np.load(os.path.join(d, f"step_{ckpt.latest_step(d):010d}",
                             "arrays.npz"))
    return {k: np.atleast_1d(z[k]).view(np.uint8) for k in z.files}


def _ckpt_worker(rank, port, queue, root):
    """Rank ``rank`` of two: 4 steps straight, then 2 steps and a resume
    to 4 in another directory; returns both logs and final arrays."""
    from repro_torch.launch import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        straight, split = os.path.join(root, "straight"), \
            os.path.join(root, "split")
        log = train.main(SMOKE + ["--steps", "4", "--ckpt-dir", straight])
        first = train.main(SMOKE + ["--steps", "2", "--ckpt-dir", split,
                                    "--ckpt-every", "1"])
        second = train.main(SMOKE + ["--steps", "4", "--ckpt-dir", split,
                                     "--resume"])
        queue.put((rank, (log, first, second,
                          _final_arrays(straight, rank),
                          _final_arrays(split, rank))))
    finally:
        dist.destroy_process_group()


def test_two_workers_resume_equals_uninterrupted(tmp_path):
    """Each rank saves its own worker state under ``rank_<r>``; a resumed
    two-worker run equals an uninterrupted one bit for bit (metrics and
    every rank's final parameters, EF memory and scalars).  Resuming
    those checkpoints with one worker raises."""
    from repro_torch.launch import train
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_ckpt_worker,
                         args=(r, port, queue, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    drop = ("step_s",)
    for rank in range(2):
        log, first, second, a_straight, a_split = got[rank]
        assert [m["step"] for m in second] == [2, 3]
        assert [{k: v for k, v in m.items() if k not in drop}
                for m in first + second] == \
            [{k: v for k, v in m.items() if k not in drop} for m in log]
        assert sorted(a_straight) == sorted(a_split)
        for k in a_straight:
            np.testing.assert_array_equal(a_straight[k], a_split[k],
                                          err_msg=f"rank {rank} {k}")
    # the two ranks hold different EF memory: a rank's own state is saved
    assert any(not np.array_equal(got[0][3][k], got[1][3][k])
               for k in got[0][3])
    created = exchange.init_process_group(torch.device("cpu"))
    try:
        with pytest.raises(ValueError, match="checkpoints of 2 workers"):
            train.main(SMOKE + ["--steps", "5", "--ckpt-dir",
                                str(tmp_path / "split"), "--resume"])
    finally:
        if created:
            dist.destroy_process_group()


def test_group_of_one_retries_a_port_taken_before_its_bind(monkeypatch):
    """A port ``_free_port`` returned can be taken before the store binds
    it (EADDRINUSE, seen once on the card): the group comes up on a fresh
    port, and a port still taken after every attempt raises."""
    with socket.socket() as taken:
        taken.bind(("localhost", 0))
        taken.listen()
        busy = taken.getsockname()[1]
        ports = [busy]
        real = exchange._free_port
        monkeypatch.setattr(exchange, "_free_port",
                            lambda: ports.pop(0) if ports else real())
        assert not dist.is_initialized()
        assert exchange.init_process_group(torch.device("cpu"))
        try:
            assert dist.get_world_size() == 1 and not ports
        finally:
            dist.destroy_process_group()
        monkeypatch.setattr(exchange, "_free_port", lambda: busy)
        with pytest.raises(dist.DistNetworkError):
            exchange.init_process_group(torch.device("cpu"))
        assert not dist.is_initialized()
