"""Per-client optimizer state and the cohort compressed exchange (twin of
``src/repro/fed/clients.py``, DESIGN.md §13).

Each data-parallel worker simulates ``C = n_clients / W`` clients.  The
JAX package ``vmap``s the selection/encode stage over them with its
kernels off (its Pallas EF kernels do not batch under ``vmap``); the
port loops over the C clients and keeps the card's kernels on the path:
per client ONE fused-EF launch pair (``core.leafmath.select_and_encode``;
``ops.fused_ef_compress_batched`` takes one eta, and the clients' etas
differ) and ONE ``comm.bucket.encode_buckets``.  The whole cohort then
moves on the bucketed transport's O(1) collective schedule:

* ONE flat ``all_gather`` of the (C, total_words) client payload block,
  gathered to (W*C, total_words), decoded in ONE ``decode_buckets``
  (with the §16 verdicts while ``faults.guards_active()``);
* ONE ``all_reduce`` carrying the concatenated participation-weighted
  dense small leaves AND the effective-byte counter.

Client IDs map to gather rows as ``rank * C + c``, so the host-built
participation mask, the same on every worker, indexes the gathered
decode directly.  With ``group=None`` the whole cohort runs on one
device with no collective, as JAX's ``dp_axes=None`` does.

JAX's unfused selection forms ``acc = m + eta*g`` and keeps
``acc - decode(own rows)``.  The fused kernels return ``sent`` and the
residual instead, and at 8 bits the decoded values are not ``sent`` (nor
need ``sent`` hold only the k_b entries on the wire when values tie at
a block's threshold), so the cohort rebuilds ``acc = sent + resid``:
each entry has one of the two at zero, so the sum is exact.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.bucket import build_bucket_plan, decode_guarded, \
    encode_buckets
from repro_torch.comm.exchange import check_bucket_payload, gather_packed
from repro_torch.core.gamma import gamma_init
from repro_torch.core.leafmath import jax_index_rules, plan_wire_bytes, \
    scatter_pairs, select_and_encode
from repro_torch.kernels.ref import ef_acc
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten
from .aggregate import aggregate_ruled, validate_aggregation

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class ClientState:
    """One worker's carried per-client optimizer state, leaves
    client-leading: the local (C, ...) slice of JAX's global
    ``(n_clients, ...)`` ``DistOptState.fed``.  Only participating clients
    advance: the EF memory, gamma, the round counter and the carried
    Armijo step of a non-participant stay as they were, bit for bit.

    ``memory`` lives on the parameters' device; the (C,) vectors on the
    host, where the per-client controllers and searches run (as the
    trainer's own scalars do)."""

    memory: dict          # per-client EF: leaves (C, *param_shape)
    gamma: torch.Tensor   # (C,) f32, per-client compression level
    rounds: torch.Tensor  # (C,) int32 participation counter (drives the
                          # per-client linear gamma schedule)
    alpha: torch.Tensor   # (C,) f32, per-client carried Armijo step


def init_client_state(params, opt, n_clients: int) -> ClientState:
    """Initial :class:`ClientState` with (n_clients, ...) leaves.  ``opt``
    reads ``ef_dtype``, ``armijo.alpha0``, ``gamma_controller`` and
    ``compressor``, as JAX's does."""
    ef_dt = getattr(torch, opt.ef_dtype)
    return ClientState(
        memory=tree_map(lambda p: torch.zeros(
            (n_clients,) + tuple(p.shape), dtype=ef_dt, device=p.device),
            params),
        gamma=torch.full((n_clients,), float(gamma_init(
            opt.gamma_controller, opt.compressor)), dtype=torch.float32),
        rounds=torch.zeros((n_clients,), dtype=torch.int32),
        alpha=torch.full((n_clients,), float(f32(opt.armijo.alpha0)),
                         dtype=torch.float32))


def local_participation(mask, group, n_local: int) -> np.ndarray:
    """This worker's (C,) slice of the (W*C,) cohort mask (host f32)."""
    m = np.asarray(mask, np.float32)
    if group is None:
        return m
    w = dist.get_rank(group)
    return m[w * n_local:(w + 1) * n_local]


def per_client_wire_bytes(plan) -> int:
    """Static uplink bytes ONE participating client transmits per round:
    its flat packed payload plus its dense small leaves (f32)."""
    dense = sum(_size(ln.shape) for ln in plan.leaves if ln.dense)
    return plan.total_words * 4 + dense * 4


def _size(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@functools.lru_cache(maxsize=8)
def _plan(shapes, stacked, comp):
    """The bucket plan of one client's tree, built once per geometry (as
    ``core.dcsgd``'s, which imports this package and so cannot be
    imported here)."""
    return build_bucket_plan(shapes, stacked, comp)


def _host_vector(x, C: int) -> np.ndarray:
    """A scalar or (C,) array / tensor as a host (C,) f32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(x, np.float32), (C,))


def cohort_compress_aggregate(grads, memory, eta_c, comp, group,
                              participation, gamma_c=None, *,
                              stacked_mask=None, aggregation="support",
                              return_quarantined=False):
    """The cohort round: per-client select/encode, ONE gather of every
    client's payload, support-weighted decode.

    ``grads`` / ``memory``: trees of client-leading ``(C, *shape)``
    leaves — this worker's local cohort.  ``eta_c``: per-client step
    sizes ``(C,)`` (a scalar broadcasts), host values.
    ``participation``: the global ``(W*C,)`` 0/1 mask of
    ``fed.sampling.participation_mask``, the same on every worker —
    client ``rank*C + c`` is this worker's c-th.  ``gamma_c``: per-client
    compression levels ``(C,)`` of an adaptive compressor
    (heterogeneous per-client k_t ride the same fixed-shape gather in
    the §9 count headers).  ``group``: the data-parallel process group,
    or None for the whole cohort on one device with no collective.

    Returns ``(updates, new_memory, wire_bytes, effective_wire_bytes)``:
    ``updates`` the aggregated dense tree (leaves ``(*shape,)``, the same
    on every worker), ``new_memory`` the per-client EF tree —
    participants keep ``acc - decode(own payload)`` (own rows sliced
    from the gathered decode), non-participants are untouched.
    ``wire_bytes`` (host float32) prices the semantic uplink: only
    participants transmit, ``n_participants *``
    :func:`per_client_wire_bytes`; ``effective_wire_bytes`` (a 0-dim f32
    tensor on the device, out of the one all-reduce) is the
    participants' sum of per-client §9 ragged byte costs.

    Decoded rows pass the §16 verdict (quarantined rows carry zero mass,
    so the support division excludes them; under ``"mean"`` they degrade
    toward zero instead), and a client whose OWN row was quarantined
    keeps that row's EF memory for the round, like a non-participant.
    With ``return_quarantined`` a fifth element is appended: this
    worker's count of quarantined gathered rows, every client's row
    counted (a 0-dim f32 tensor on the device)."""
    validate_aggregation(aggregation)
    flat_g, structure = tree_flatten(grads)
    flat_m = tree_flatten(memory)[0]
    if not flat_g:
        raise ValueError("empty gradient tree")
    W = 1 if group is None else dist.get_world_size(group)
    C = flat_g[0].shape[0]
    N = W * C
    flat_s = ([g.dim() - 1 >= 2 for g in flat_g] if stacked_mask is None
              else tree_flatten(stacked_mask)[0])
    if isinstance(participation, torch.Tensor):
        participation = participation.detach().cpu().numpy()
    part = np.asarray(participation, np.float32)
    if part.shape != (N,):
        raise ValueError(f"participation mask is {part.shape}, cohort "
                         f"has {N} clients ({W} workers x {C})")
    eta_c = _host_vector(eta_c, C)
    gamma_c = _host_vector(
        (comp.gamma if comp.adaptive else 0.0) if gamma_c is None
        else gamma_c, C)
    device = flat_g[0].device

    plan = _plan(tuple(tuple(g.shape[1:]) for g in flat_g),
                 tuple(bool(s) for s in flat_s), comp)
    lanes = plan.leaves
    n = len(lanes)
    pl = local_participation(part, group, C)             # (C,) host
    n_part = f32(part.sum())

    # ---- per-client selection + encode: one launch set a client --------
    payloads = torch.empty((C, plan.total_words), dtype=torch.int32,
                           device=device)
    accs = {ln.index: torch.empty((C, ln.L, ln.d), dtype=torch.float32,
                                  device=device)
            for ln in lanes if not ln.dense}
    dense_ids = list(plan.dense_ids)
    dense_acc = []                                       # C x [dense leaves]
    eff_c = []
    for c in range(C):
        gs = [g[c] for g in flat_g]
        ms = [m[c] for m in flat_m]
        eta = torch.full((1,), float(eta_c[c]), dtype=torch.float32,
                         device=device)
        gamma_t = f32(gamma_c[c]) if comp.adaptive else None
        sel = select_and_encode(gs, ms, flat_s, eta, comp, gamma_t, plan)
        if plan.total_words:
            payloads[c] = encode_buckets(plan, sel.enc_rows)
        for i, acc in accs.items():
            # the fused kernels' sent + residual is acc exactly
            acc[c] = sel.sent[i] + sel.resid[i] if sel.use_fused \
                else sel.acc2[i]
        dense_acc.append([ef_acc(ms[i], gs[i], eta).reshape(-1)
                          for i in dense_ids])
        eff_c.append(plan_wire_bytes(plan, comp, gamma_t)[1])
        del sel

    # ---- ONE gather: the whole cohort's payload block ------------------
    decoded = verdicts = [None] * n
    if plan.total_words:
        check_bucket_payload(payloads[0], plan, comp)
        all_pay = payloads if group is None else gather_packed(
            payloads, group).reshape(N, plan.total_words)
        decoded, verdicts = decode_guarded(plan, all_pay)
    w_idx = 0 if group is None else dist.get_rank(group)

    updates: list = [None] * n
    new_mem: list = [None] * n
    n_part_t = torch.tensor(n_part, dtype=torch.float32, device=device)

    # ---- dense small leaves + eff counter: ONE all-reduce ---------------
    # (dense rows reach every participant in full, so support equals
    # n_participants at every coordinate: one division for both modes)
    # the clients summed in order from +0, as XLA reduces the client axis
    eff_local = f32(0.0)
    weighted = torch.zeros((sum(_size(lanes[i].shape) for i in dense_ids),),
                           dtype=torch.float32, device=device)
    for c in range(C):
        eff_local = f32(eff_local + f32(pl[c]) * eff_c[c])
        if dense_ids:
            weighted = weighted + torch.cat(dense_acc[c]) * float(pl[c])
    vec = torch.cat([weighted, torch.tensor(
        [eff_local], dtype=torch.float32, device=device)])
    if group is not None:
        dist.all_reduce(vec, group=group)
    eff_wire = vec[-1]
    keep_c = torch.from_numpy(pl > 0.0).to(device)       # (C,) bool
    off = 0
    for i in dense_ids:
        ln = lanes[i]
        size = _size(ln.shape)
        updates[i] = (vec[off:off + size]
                      / n_part_t.clamp_min(1.0)).reshape(ln.shape)
        off += size
        m = flat_m[i]
        new_mem[i] = torch.where(
            keep_c.reshape((C,) + (1,) * (m.dim() - 1)), 0.0,
            m.float()).to(m.dtype)

    # ---- compressed leaves: support-weighted aggregate + per-client EF -
    weights = torch.from_numpy(part).to(device)
    quar = torch.zeros((), dtype=torch.float32, device=device)
    for ln in lanes:
        if ln.dense:
            continue
        i, L, d = ln.index, ln.L, ln.d
        vals, idx = decoded[i]                           # (N, L, k)
        # JAX's index rules once, for the aggregate and the own rows
        s_vals, s_idx = jax_index_rules(vals, idx, d)
        updates[i] = aggregate_ruled(s_vals, s_idx, weights, L, d, n_part_t,
                                     aggregation).reshape(ln.shape)
        own = slice(w_idx * C, (w_idx + 1) * C)
        own_dense = scatter_pairs(s_vals[own].reshape(C * L, -1),
                                  s_idx[own].reshape(C * L, -1), C * L,
                                  d).reshape(C, L, d)
        m = flat_m[i]
        keep = keep_c.reshape(C, 1, 1)
        if verdicts[i] is not None:
            # a quarantined own row freezes that client's EF for the
            # round, like a non-participant (§16)
            keep = keep & verdicts[i][own][:, :, None]
            quar = quar + (1.0 - verdicts[i].to(torch.float32)).sum()
        r = torch.where(keep, accs[i] - own_dense,
                        m.float().reshape(C, L, d))
        new_mem[i] = r.reshape(m.shape).to(m.dtype)
        del own_dense, r

    wire = n_part * f32(per_client_wire_bytes(plan))
    out = (tree_unflatten(structure, updates),
           tree_unflatten(structure, new_mem), wire, eff_wire)
    return out + (quar,) if return_quarantined else out
