"""Worker bodies of the multi-process ring and overlap tests
(tests/test_torch_ring.py, tests/test_torch_overlap.py,
tests/test_torch_overlap_train.py): a helper, not collected.

A spawned worker unpickles its target by module name, so these live in
a module that imports no JAX: each worker then pays for torch alone.
:func:`spawn` runs ``fn(rank, W, *args)`` on W gloo workers and returns
``{rank: result}``; :class:`Spawned` starts them and returns at once.
"""
import multiprocessing as mp
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import exchange, ring
from repro_torch.comm.bucket import build_bucket_plan, encode_buckets
from repro_torch.comm.overlap import OverlapConfig, OverlapCtx, \
    init_overlap_state, post_carried
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate
from repro_torch.core.leafmath import select_and_encode
from repro_torch.utils import tree_leaves

f32 = np.float32
#: a stacked leaf, a flat one, two dense ones and one past 65,536 entries
#: (32-bit flat indices) — tests/distributed/test_overlap_exchange.py's
SHAPES = [(2, 2048), (3000,), (50,), (40,), (70000,)]
STACKED = [True, False, False, False, False]
#: leaf names in flat (sorted) order
NAMES = [f"l{i}" for i in range(len(SHAPES))]


def _entry(rank, W, port, queue, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=W, rank=rank)
    try:
        queue.put((rank, fn(rank, W, *args)))
    finally:
        dist.destroy_process_group()


class Spawned:
    """``fn(rank, W, *args)`` on W gloo workers, started now so that the
    caller can work meanwhile; :meth:`result` waits and returns
    ``{rank: result}``.  ``preload``: modules for a fork server to import
    once, the workers then forked from it (each spawned worker would
    import torch on its own); the default spawns each worker."""

    def __init__(self, fn, W, *args, preload=None):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn" if preload is None else "forkserver")
        if preload is not None:
            ctx.set_forkserver_preload(list(preload))
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, W, port, self.queue, fn, args))
                      for r in range(W)]
        for p in self.procs:
            p.start()
        self.got = None

    def result(self, timeout=240):
        if self.got is None:
            self.got = dict(self.queue.get(timeout=timeout)
                            for _ in self.procs)
            for p in self.procs:
                p.join(timeout=60)
                assert not p.is_alive() and p.exitcode == 0
        return self.got


def spawn(fn, W, *args, timeout=240):
    return Spawned(fn, W, *args).result(timeout)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def ring_payload(rank, adaptive):
    """One worker's bucket payload of a plain (8-bit block_topk) or a
    ragged (adaptive, 10% budget at a per-rank gamma_t) compressor."""
    comp = Compressor(gamma=0.05, method="block_topk", block=512,
                      min_compress_size=64, value_bits=8) if not adaptive \
        else Compressor(gamma=0.01, max_gamma=0.1, method="block_topk",
                        min_compress_size=64, value_bits=8)
    rng = np.random.default_rng(7 + rank)
    g = [torch.from_numpy(rng.standard_normal(s).astype(f32))
         for s in SHAPES]
    m = [torch.zeros(s) for s in SHAPES]
    plan = build_bucket_plan(SHAPES, STACKED, comp)
    sel = select_and_encode(g, m, STACKED, torch.tensor([0.5]), comp,
                            f32((0.02, 0.07)[rank % 2]) if adaptive
                            else None, plan)
    return encode_buckets(plan, sel.enc_rows)


def ring_gathers(rank, W, chunks):
    """For each payload kind and chunk count: (adaptive, n_chunks, ring ==
    gather_packed, the ring's shape, the send hops it posted, the payload
    words)."""
    sends = []
    real = dist.batch_isend_irecv

    def counting(ops):
        sends.append(sum(op.op is dist.isend for op in ops))
        return real(ops)

    dist.batch_isend_irecv = counting
    try:
        out = []
        for adaptive in (False, True):
            payload = ring_payload(rank, adaptive)
            flat = exchange.gather_packed(payload)
            for nc in chunks:
                sends.clear()
                got = ring.ring_all_gather(payload, None, nc)
                out.append((adaptive, nc, torch.equal(got, flat),
                            tuple(got.shape), sum(sends),
                            payload.numel()))
        return out
    finally:
        dist.batch_isend_irecv = real


# ---------------------------------------------------------------------------
# the overlap exchange
# ---------------------------------------------------------------------------

#: tests/distributed/test_overlap_exchange.py's compressor: per-worker
#: k_t riding the ragged count headers of a 5% budget, 8-bit values
HETERO = dict(gamma=0.05, max_gamma=0.05, method="block_topk", block=512,
              min_compress_size=64, value_bits=8)


def exchange_inputs(seed, mem_seed=None):
    rng = np.random.default_rng(seed)
    g = {n: rng.standard_normal(s).astype(f32)
         for n, s in zip(NAMES, SHAPES)}
    if mem_seed is None:
        return g
    rng = np.random.default_rng(mem_seed)
    m = {n: (0.1 * rng.standard_normal(s)).astype(f32)
         for n, s in zip(NAMES, SHAPES)}
    return g, m


def hetero_gamma(rank, W, comp):
    """Worker ``rank``'s gamma_t, spread over [max_gamma / 8, max_gamma]."""
    return np.linspace(comp.max_gamma / 8.0, comp.max_gamma, W).astype(
        f32)[rank]


def run_exchange(g, m, comp, transport, gamma_t=None, ctx=None, eta=0.1):
    """One exchange as numpy: (updates, memory, wire, eff, telemetry
    fields, new overlap state or None)."""
    smask = dict(zip(NAMES, STACKED))
    out = worker_compress_aggregate(
        to_torch(g), m if isinstance(next(iter(m.values())), torch.Tensor)
        else to_torch(m), f32(eta), comp, stacked_mask=smask,
        gamma_t=gamma_t, transport=transport, transport_ctx=ctx)
    tel = out[4]
    return (to_numpy(out[0]), out[1], float(out[2]), float(out[3]),
            [float(getattr(tel, f)) for f in ("ef_backlog", "cosine",
                                              "decode_error", "eff_gamma")],
            out[5] if ctx is not None else None)


def fresh_state(comp):
    return init_overlap_state(SHAPES, STACKED, comp)


def state_numpy(st):
    return (st.payload.numpy().copy(), st.dense.numpy().copy(),
            float(st.eff_wire), float(st.seeded))


def mem_numpy(m):
    return to_numpy(m)


def delay0_and_early_start(rank, W):
    """Delay 0 against bucketed (two rounds, the second from each one's
    carried memory), and delay 1 with its collectives posted early
    against a late post, on this worker's own gradients at a per-rank
    gamma_t."""
    comp = Compressor(**HETERO)
    gt = hetero_gamma(rank, W, comp)
    g1, m1 = exchange_inputs(10 + rank, 20 + rank)
    g2 = exchange_inputs(30 + rank)
    res = {}
    for nc in (1, 3):
        cfg = OverlapConfig(n_chunks=nc, delay=0)
        b1 = run_exchange(g1, m1, comp, "bucketed", gt)
        o1 = run_exchange(g1, m1, comp, "overlap", gt,
                          OverlapCtx(cfg, fresh_state(comp)))
        b2 = run_exchange(g2, b1[1], comp, "bucketed", gt)
        o2 = run_exchange(g2, o1[1], comp, "overlap", gt,
                          OverlapCtx(cfg, o1[5]))
        res[f"delay0-nc{nc}"] = [
            (b[:1] + (mem_numpy(b[1]),) + b[2:5],
             o[:1] + (mem_numpy(o[1]),) + o[2:5], state_numpy(o[5]))
            for b, o in ((b1, o1), (b2, o2))]
    # delay 1: the carried state of one round, then the same round with
    # the collectives posted before some unrelated compute, and late
    cfg = OverlapConfig(n_chunks=3, delay=1)
    carried = run_exchange(g1, m1, comp, "overlap", gt,
                           OverlapCtx(cfg, fresh_state(comp)))[5]
    started = post_carried(carried, None, cfg.n_chunks)
    torch.randn(256, 256) @ torch.randn(256, 256)
    early = run_exchange(g2, m1, comp, "overlap", gt,
                         OverlapCtx(cfg, carried, started))
    late = run_exchange(g2, m1, comp, "overlap", gt,
                        OverlapCtx(cfg, carried))
    res["early-late"] = [
        (e[:1] + (mem_numpy(e[1]),) + e[2:5] + (state_numpy(e[5]),))
        for e in (early, late)]
    return res


def warmup_and_staleness(rank, W):
    """tests/distributed/test_overlap_exchange.py:192-232 on this worker:
    bucketed and delay-1 overlap rounds 1 and 2 at a per-rank gamma_t."""
    comp = Compressor(**HETERO)
    cfg = OverlapConfig(n_chunks=2, delay=1)
    gt = hetero_gamma(rank, W, comp)
    g1, m1 = exchange_inputs(40 + rank, 50 + rank)
    g2 = exchange_inputs(60 + rank)
    buck1 = run_exchange(g1, m1, comp, "bucketed", gt)
    ov1 = run_exchange(g1, m1, comp, "overlap", gt,
                       OverlapCtx(cfg, fresh_state(comp)))
    buck2 = run_exchange(g2, buck1[1], comp, "bucketed", gt)
    ov2 = run_exchange(g2, ov1[1], comp, "overlap", gt,
                       OverlapCtx(cfg, ov1[5]))
    pack = lambda r: (r[0], mem_numpy(r[1]), r[2], r[3])  # noqa: E731
    return dict(buck1=pack(buck1), ov1=pack(ov1), buck2=pack(buck2),
                ov2=pack(ov2), seeded1=float(ov1[5].seeded),
                zero_eff=float(fresh_state(comp).eff_wire))


#: tests/distributed/test_overlap_exchange.py:235-280: d 512, T 120
QUAD_D, QUAD_T, QUAD_ETA = 512, 120, 0.1
QUAD_COMP = dict(gamma=0.25, method="block_topk", block=128,
                 min_compress_size=64, value_bits=32)


def quadratic_data(W, seed=0):
    """(a_w, b_w): worker-heterogeneous diagonal quadratics, (W, d) each."""
    rng = np.random.default_rng(seed)
    a = (0.5 + rng.uniform(size=(W, QUAD_D))).astype(f32)
    b = rng.standard_normal((W, QUAD_D)).astype(f32)
    return a, b


def quadratic_trajectories(rank, W):
    """x after T steps of fixed-gamma compressed SGD on this worker's
    quadratic f_w(x) = sum(0.5 a_w x^2 - b_w x), through bucketed and
    through delay-1 overlap (2 chunks)."""
    comp = Compressor(**QUAD_COMP)
    a, b = quadratic_data(W)
    a_w, b_w = torch.from_numpy(a[rank]), torch.from_numpy(b[rank])
    out = {}
    for transport in ("bucketed", "overlap"):
        x = torch.zeros(QUAD_D)
        mem = {"x": torch.zeros(QUAD_D)}
        ov = init_overlap_state([(QUAD_D,)], [False], comp) \
            if transport == "overlap" else None
        for _ in range(QUAD_T):
            res = worker_compress_aggregate(
                {"x": a_w * x - b_w}, mem, f32(QUAD_ETA), comp,
                transport=transport,
                transport_ctx=None if ov is None else OverlapCtx(
                    OverlapConfig(n_chunks=2, delay=1), ov))
            x = x - res[0]["x"]
            mem = res[1]
            if ov is not None:
                ov = res[5]
        out[transport] = x.numpy().copy()
    return out


def four_worker_checks(rank, W):
    """(:func:`warmup_and_staleness`, :func:`quadratic_trajectories`)."""
    return warmup_and_staleness(rank, W), quadratic_trajectories(rank, W)


# ---------------------------------------------------------------------------
# the trainer's CLI on two workers
# ---------------------------------------------------------------------------

def _final_arrays(d, rank):
    from repro_torch.checkpoint import checkpoint as ckpt
    d = os.path.join(d, f"rank_{rank:03d}")
    z = np.load(os.path.join(d, f"step_{ckpt.latest_step(d):010d}",
                             "arrays.npz"))
    return {k: np.atleast_1d(z[k]).view(np.uint8) for k in z.files}


def cli_resume(rank, W, argv, root):
    """3 steps straight, then 2 and a resume to 3 in another directory;
    the logs, both final checkpoints and the final parameters."""
    from repro_torch.launch import train
    straight, split = os.path.join(root, "straight"), \
        os.path.join(root, "split")
    log, params, _ = train.run(argv + ["--steps", "3", "--ckpt-dir",
                                       straight])
    first = train.main(argv + ["--steps", "2", "--ckpt-dir", split,
                               "--ckpt-every", "1"])
    second = train.main(argv + ["--steps", "3", "--ckpt-dir", split,
                                "--resume"])
    return (log, first, second, _final_arrays(straight, rank),
            _final_arrays(split, rank),
            [x.numpy().copy() for x in tree_leaves(params)])
