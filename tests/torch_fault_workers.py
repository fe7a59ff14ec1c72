"""Worker bodies of the multi-process fault tests
(tests/test_torch_faulty_train.py): a helper, not collected.  Like
tests/torch_overlap_workers.py (whose ``Spawned`` runs them) it imports
no JAX, so a spawned worker pays for torch alone.
"""
import numpy as np

from repro_torch.comm import faults
from repro_torch.comm import gossip as gs
from repro_torch.comm.topology import build_topology
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.core.dcsgd import worker_compress_aggregate

f32 = np.float32
#: a stacked and a flat compressed leaf and a dense one: every kind of
#: lane at a third of tests/torch_overlap_workers.py's JAX compile time
SHAPES = [(2, 1024), (3000,), (40,)]
STACKED = [True, False, False]
NAMES = [f"l{i}" for i in range(len(SHAPES))]
ETA = 0.3
#: the burst: round 0 runs at step START (inside), round 1 at START + 1
#: (outside)
START = 2
#: exchange cases: (inner transport, compressor, campaign); bucketed's
#: campaign hits worker 1's gathered rows, gossip's every exchanged slot
#: (slot 0 is the worker's own row)
CASES = {
    "bucketed": ("bucketed",
                 dict(gamma=0.05, method="topk", min_compress_size=64,
                      value_bits=8),
                 dict(seed=5, p_nonfinite=0.6, p_bitflip=0.5, worker=1)),
    "gossip": ("gossip",
               dict(gamma=0.05, method="topk", min_compress_size=64,
                    value_bits=32),
               dict(seed=6, p_nonfinite=0.5, p_bitflip=0.7)),
}


def campaign(case, quarantine):
    return faults.FaultConfig(start_step=START, n_steps=1,
                              quarantine=quarantine, **CASES[case][2])


def exchange_inputs(seed, mem_seed):
    """(grads, EF memory) of the tree, f32 normal draws (memory x 0.1)."""
    g = np.random.default_rng(seed)
    m = np.random.default_rng(mem_seed)
    return ({n: g.standard_normal(s).astype(f32)
             for n, s in zip(NAMES, SHAPES)},
            {n: (0.1 * m.standard_normal(s)).astype(f32)
             for n, s in zip(NAMES, SHAPES)})


def inputs(case_idx, rank, rnd):
    """(grads, initial EF memory) of worker ``rank`` in round ``rnd``."""
    return exchange_inputs(100 * case_idx + 10 * rank + rnd,
                           200 * case_idx + 10 * rank)


def fault_rounds(rank, W, case, quarantine):
    """Two exchanges of ``case`` through the faulty wrapper, the second
    from the first one's EF memory (and gossip state): per round the
    updates, EF memory, wire and effective bytes, quarantined rows and
    the gossip (v, lr)."""
    inner, comp_kw, _ = CASES[case]
    comp = Compressor(**comp_kw)
    cfg = campaign(case, quarantine)
    smask = dict(zip(NAMES, STACKED))
    state = gs.GossipState.init()
    topo = build_topology("ring", W)
    mem, out = None, []
    for rnd in range(2):
        g, m0 = inputs(list(CASES).index(case), rank, rnd)
        mem = to_torch(m0) if mem is None else mem
        ctx = gs.GossipCtx(topo, gs.GossipConfig(), state) \
            if inner == "gossip" else None
        res = worker_compress_aggregate(
            to_torch(g), mem, f32(ETA), comp, stacked_mask=smask,
            transport="faulty", transport_ctx=faults.FaultCtx(
                cfg=cfg, step=START + rnd, inner=inner, inner_ctx=ctx))
        mem = res[1]
        if inner == "gossip":
            state = res[5]
        else:
            assert res[5] == ()
        out.append(dict(upd=to_numpy(res[0]), mem=to_numpy(res[1]),
                        wire=float(res[2]), eff=float(res[3]),
                        quar=float(res[4].rows_quarantined),
                        v=float(state.v), lr=float(state.lr)))
    return out


def all_fault_rounds(rank, W):
    return {(case, q): fault_rounds(rank, W, case, q)
            for case in CASES for q in (True, False)}

