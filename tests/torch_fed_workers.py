"""Cohort inputs and worker bodies of the federated tests
(tests/test_torch_fed.py, tests/test_torch_fed_train.py): a helper, not
collected.  Like tests/torch_overlap_workers.py (whose ``Spawned`` runs
them) it imports no JAX, so a forked worker pays for torch alone.

The exchange cases cross the cohort's dimensions: ``topk`` and
``block_topk``, 32- and 8-bit values, the fixed budget and per-client
ragged gamma, ``support`` and ``mean``, under a mask with a
non-participant; three more run fault campaigns (two guarded, one with
``quarantine=False``, whose bit flips reach the scatter as out-of-range
indices and subnormal, infinite or NaN values).
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import faults
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.compression import Compressor
from repro_torch.fed.clients import cohort_compress_aggregate
from repro_torch.fed.sampling import participation_mask

f32 = np.float32
#: a stacked and a flat compressed leaf and a dense one
SHAPES = [(2, 1536), (40,)]
STACKED = [True, False]
NAMES = [f"l{i}" for i in range(len(SHAPES))]
SMASK = dict(zip(NAMES, STACKED))
#: the cohort: 4 clients, 3 taking part (client 3 sits out); on 2
#: workers each holds 2
N_CLIENTS = 4
MASK = participation_mask(N_CLIENTS, 1, seed=0, mode="fixed",
                          clients_per_round=3)
#: the round index the fault campaigns are keyed on
STEP = 5


def comp_kw(method, bits, ragged):
    return dict(gamma=0.05, method=method, min_compress_size=64,
                value_bits=bits, max_gamma=0.1 if ragged else 0.0,
                block=512)


#: name -> (compressor kwargs, aggregation, fault campaign or None)
CASES = {
    f"{method}-{bits}-{'ragged' if ragged else 'fixed'}-{agg}": (
        comp_kw(method, bits, ragged), agg, None)
    for method in ("topk", "block_topk") for bits in (32, 8)
    for ragged in (False, True) for agg in ("support", "mean")}
CASES.update({
    "faults-nonfinite-bitflip": (
        comp_kw("block_topk", 8, True), "support",
        dict(seed=3, p_nonfinite=0.5, p_bitflip=0.5)),
    "faults-count-zero-row-client1": (
        comp_kw("topk", 32, True), "mean",
        dict(seed=4, p_count=0.7, p_zero_row=0.3, worker=1)),
    "faults-unguarded-bitflip": (
        comp_kw("topk", 32, False), "support",
        dict(seed=9, p_bitflip=1.0, quarantine=False)),
})


def cohort_inputs(name):
    """(grads, EF memory, eta_c, gamma_c) of all N_CLIENTS clients,
    client-leading f32 draws (memory x 0.1), seeded by the case's
    compressor: a support case and its mean twin share their inputs (and
    so, in one jitted JAX program, their selection and encode)."""
    kw = CASES[name][0]
    rng = np.random.default_rng(
        [kw["method"] == "topk", kw["value_bits"], kw["max_gamma"] > 0,
         CASES[name][2] is not None])
    g = {n: rng.standard_normal((N_CLIENTS,) + s).astype(f32)
         for n, s in zip(NAMES, SHAPES)}
    m = {n: (0.1 * rng.standard_normal((N_CLIENTS,) + s)).astype(f32)
         for n, s in zip(NAMES, SHAPES)}
    eta = np.linspace(0.1, 0.4, N_CLIENTS, dtype=f32)
    gamma = np.linspace(0.02, 0.1, N_CLIENTS, dtype=f32)
    return g, m, eta, gamma


def port_case(name, rows, group):
    """The port's cohort exchange of ``CASES[name]`` over clients
    ``rows`` (a slice of the cohort), as NumPy: (updates, memory, wire,
    eff, quarantined rows)."""
    kw, agg, fkw = CASES[name]
    g, m, eta, gamma = cohort_inputs(name)
    local = lambda t: to_torch({n: v[rows] for n, v in t.items()})  # noqa
    scope = faults.active_faults(faults.FaultConfig(**fkw), STEP) \
        if fkw else contextlib.nullcontext()
    with scope:
        out = cohort_compress_aggregate(
            local(g), local(m), eta[rows], Compressor(**kw), group, MASK,
            gamma[rows], stacked_mask=SMASK, aggregation=agg,
            return_quarantined=True)
    return (to_numpy(out[0]), to_numpy(out[1]), float(out[2]),
            float(out[3]), float(out[4]))


def cohort_exchanges(rank, W):
    """Every case on this rank's clients over the gloo group."""
    torch.set_num_threads(1)
    C = N_CLIENTS // W
    rows = slice(rank * C, (rank + 1) * C)
    return {name: port_case(name, rows, dist.group.WORLD) for name in CASES}


def cohort_trainer_rounds(rank, W, run, path):
    """The trainer's cohort rounds on this rank's clients, each round
    from the state pickled at ``path`` (a list of (params, client state,
    tokens, mask) of the whole cohort, as NumPy): per round the new
    parameters, this rank's clients' state, the metrics and the health
    counters."""
    import dataclasses
    import pickle

    from repro_torch.fed.clients import ClientState
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.utils import tree_map
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        rounds = pickle.load(f)
    C = run.optimizer.federated.n_clients // W
    rows = slice(rank * C, (rank + 1) * C)
    state, out = None, []
    for params, fst, tokens, mask in rounds:
        tparams = to_torch(params)
        if state is None:
            state = init_train_state(tparams, run, W)
        state = dataclasses.replace(state, fed=ClientState(
            memory=to_torch(tree_map(lambda x: x[rows], fst[0])),
            gamma=torch.from_numpy(fst[1][rows]),
            rounds=torch.from_numpy(fst[2][rows]),
            alpha=torch.from_numpy(fst[3][rows])))
        new_params, state, m = train_step(
            tparams, state, {"tokens": torch.from_numpy(tokens[rows]),
                             "participation": mask}, run)
        h = state.health
        out.append(dict(
            params=to_numpy(new_params), mem=to_numpy(state.fed.memory),
            gamma=state.fed.gamma.numpy(), rounds=state.fed.rounds.numpy(),
            alpha=state.fed.alpha.numpy(), metrics=m,
            health=(h.steps_skipped, h.consecutive_skips, h.last_good_step,
                    float(h.rows_quarantined))))
    return out
