"""Worker bodies of the multi-process gossip tests
(tests/test_torch_gossip.py, tests/test_torch_gossip_train.py): a
helper, not collected.  Like tests/torch_overlap_workers.py (whose
``spawn`` and ``Spawned`` run them) it imports no JAX, so a spawned
worker pays for torch alone.
"""
import numpy as np
import torch

from repro_torch.comm import gossip as gs
from repro_torch.comm.topology import build_topology
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate

import torch_overlap_workers as ow

f32 = np.float32
SHAPES, STACKED, NAMES = ow.SHAPES, ow.STACKED, ow.NAMES
TEL = ("ef_backlog", "cosine", "decode_error", "eff_gamma")

#: exchange cases: (compressor, per-worker gamma_t or None, GossipConfig
#: fields).  Block top-k and exact top-k at 32 and 8 bits; a ragged 10%
#: budget at per-worker gamma_t; a small consensus_lr and lr_max, so the
#: adaptive step lies below its cap and ``own + lr_t*e`` is exercised.
CASES = {
    "block-v32": (dict(gamma=0.05, method="block_topk", block=512,
                       min_compress_size=64), None, {}),
    "block-v8": (dict(gamma=0.05, method="block_topk", block=512,
                      min_compress_size=64, value_bits=8), None, {}),
    "topk-v32": (dict(gamma=0.05, method="topk", min_compress_size=64),
                 None, {}),
    "topk-v8": (dict(gamma=0.05, method="topk", min_compress_size=64,
                     value_bits=8), None, {}),
    "ragged-v8": (dict(gamma=0.04, max_gamma=0.1, method="block_topk",
                       min_compress_size=64, value_bits=8), True, {}),
    "active-lr": (dict(gamma=0.05, method="topk", min_compress_size=64),
                  None, dict(consensus_lr=0.03, lr_max=0.7, beta=0.5)),
}
#: (topology, W) -> the cases held at it (each block_topk case compiles
#: JAX's interpret-mode Pallas kernels, ~3.5 s each)
PLAN = {("ring", 1): ("block-v32",),
        ("ring", 2): ("topk-v8",),
        ("ring", 3): ("ragged-v8",),
        ("ring", 4): ("block-v8", "active-lr"),
        ("torus", 4): ("topk-v32",),
        ("exp", 4): ("topk-v8",)}
ROUNDS, ETA = 2, 0.3


def case_gamma(case, rank, W):
    """Worker ``rank``'s gamma_t of ``case`` (None unless adaptive)."""
    kw, adaptive, _ = CASES[case]
    if not adaptive:
        return None
    return np.linspace(kw["gamma"], kw["max_gamma"], max(W, 2)).astype(
        f32)[rank]


def round_inputs(case_idx, rank, rnd):
    """(grads, initial EF memory) of worker ``rank`` in round ``rnd``."""
    g, m = ow.exchange_inputs(1000 * case_idx + 10 * rank + rnd,
                              2000 * case_idx + 10 * rank)
    return g, m


def gossip_case(rank, W, topo_name, case):
    """``ROUNDS`` gossip exchanges of ``case`` on this worker, each from
    the previous one's EF memory and (v, lr): per round the updates, EF
    memory, wire and effective bytes, telemetry, v, lr and the exchanged
    (degree+1, words) rows."""
    kw, _, cfg_kw = CASES[case]
    comp = Compressor(**kw)
    topo = build_topology(topo_name, W)
    cfg = gs.GossipConfig(topology=topo_name, **cfg_kw)
    state = gs.GossipState.init()
    smask = dict(zip(NAMES, STACKED))
    seen = []
    real = gs.exchange_rows

    def recording(buf, topo_, group=None):
        seen.append(real(buf, topo_, group))
        return seen[-1]

    gs.exchange_rows = recording
    try:
        out, mem = [], None
        for rnd in range(ROUNDS):
            g, m0 = round_inputs(list(CASES).index(case), rank, rnd)
            res = worker_compress_aggregate(
                to_torch(g), to_torch(m0) if mem is None else mem, f32(ETA),
                comp, stacked_mask=smask, gamma_t=case_gamma(case, rank, W),
                transport="gossip",
                transport_ctx=gs.GossipCtx(topo, cfg, state))
            upd, mem, wire, eff, tel, state = res
            out.append(dict(
                upd=to_numpy(upd), mem=to_numpy(mem), wire=float(wire),
                eff=float(eff),
                tel=[float(getattr(tel, f)) for f in TEL],
                v=state.v.numpy().copy(), lr=state.lr.numpy().copy(),
                rows=seen[-1].numpy().copy()))
        return out
    finally:
        gs.exchange_rows = real


def gossip_cases(rank, W):
    """Every (topology, case) of ``PLAN`` at this W."""
    return {(t, c): gossip_case(rank, W, t, c)
            for (t, w), cases in PLAN.items() if w == W for c in cases}


# ---------------------------------------------------------------------------
# tests/distributed/test_gossip_exchange.py's golden claim and gossip_mix
# ---------------------------------------------------------------------------

#: :150-227 — per-worker quadratics g_i = x_i - c_i, K steps
SIM_L, SIM_D, SIM_DB, SIM_K, SIM_ETA = 4, 256, 48, 5, 0.1
SIM_COMP = dict(gamma=0.05, method="topk", value_bits=32,
                min_compress_size=64)


def sim_data(W, seed=5):
    """(x0, c): {"w": (W, L, D), "b": (W, DB)} each, f32."""
    rng = np.random.default_rng(seed)
    mk = lambda: {"w": rng.standard_normal((W, SIM_L, SIM_D)).astype(f32),  # noqa: E731
                  "b": rng.standard_normal((W, SIM_DB)).astype(f32)}
    return mk(), mk()


def simulate(rank, W, topo_name):
    """K gossip steps of this worker's quadratic: final x, EF memory, v."""
    comp = Compressor(**SIM_COMP)
    topo = build_topology(topo_name, W)
    cfg = gs.GossipConfig(topology=topo_name)
    x0, c = sim_data(W)
    x = {k: torch.from_numpy(v[rank].copy()) for k, v in x0.items()}
    tgt = {k: torch.from_numpy(v[rank].copy()) for k, v in c.items()}
    m = {k: torch.zeros_like(v) for k, v in x.items()}
    state = gs.GossipState.init()
    for _ in range(SIM_K):
        g = {k: x[k] - tgt[k] for k in x}
        upd, m, _, _, _, state = worker_compress_aggregate(
            g, m, f32(SIM_ETA), comp, transport="gossip",
            transport_ctx=gs.GossipCtx(topo, cfg, state))
        x = {k: x[k] - upd[k] for k in x}
    return to_numpy(x), to_numpy(m), float(state.v)


def mix_data(W, seed=9):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((W, 32)).astype(f32),
            "b": rng.standard_normal((W, 3, 7)).astype(f32)}


MIX_ROUNDS = 6


def mix_rounds(rank, W, topo_name):
    """``MIX_ROUNDS`` uncompressed ``gossip_mix`` rounds of this worker's
    rows of :func:`mix_data`, each round's output; then one round of a
    tree that is the same on every worker."""
    topo = build_topology(topo_name, W)
    cur = {k: torch.from_numpy(v[rank].copy())
           for k, v in mix_data(W).items()}
    out = []
    for _ in range(MIX_ROUNDS):
        cur = gs.gossip_mix(cur, topo)
        out.append(to_numpy(cur))
    const = {k: v * 0 + torch.from_numpy(mix_data(W, 3)[k][0])
             for k, v in cur.items()}
    return out, to_numpy(const), to_numpy(gs.gossip_mix(const, topo))


def four_workers(rank, W):
    """Everything the W = 4 tests need, from one set of workers."""
    return dict(cases=gossip_cases(rank, W),
                sim={t: simulate(rank, W, t) for t in ("ring", "exp")},
                mix={t: mix_rounds(rank, W, t) for t in ("ring", "exp")})


# ---------------------------------------------------------------------------
# the trainer's gossip round (tests/test_torch_gossip_train.py)
# ---------------------------------------------------------------------------

def gossip_trainer_rounds(rank, W, run, path, seq, batch_size):
    """``train_step`` on this worker's rows of each round's batch, each
    round from the parameters and EF memory pickled under ``path`` for
    this rank (the reference's), with the port's own carried scalars and
    (v, lr)."""
    import dataclasses
    import pickle

    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    with open(f"{path}/rank_{rank}.pkl", "rb") as f:
        inputs = pickle.load(f)
    state = init_train_state(to_torch(inputs[0][0]), run)
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=seq,
                         global_batch=batch_size)
    rows = slice(rank * batch_size // W, (rank + 1) * batch_size // W)
    out = []
    for t, (p_np, m_np) in enumerate(inputs):
        state = dataclasses.replace(state, memory=to_torch(m_np))
        batch = {k: v[rows] for k, v in pipe.batch(t).items()}
        params, state, m = train_step(to_torch(p_np), state, batch, run)
        h = state.health
        out.append(dict(params=to_numpy(params), mem=to_numpy(state.memory),
                        v=float(state.gossip.v), lr=float(state.gossip.lr),
                        gamma=float(state.gamma), metrics=m,
                        health=(h.steps_skipped, h.consecutive_skips,
                                h.last_good_step)))
    return out
