"""Serverless gossip exchange over the bucketed wire format (twin of
``src/repro/comm/gossip.py``, DESIGN.md §12).

The stateful ``transport="gossip"``.  Same selection, same EF arithmetic
and the same ONE flat int32 payload buffer as ``transport="bucketed"``,
but no worker ever sees the whole fleet: the buffer moves by ``degree``
point-to-point sends along a fixed
:class:`~repro_torch.comm.topology.Topology` instead of one
``all_gather``, the dense small leaves ride the same buffer (their f32
accumulators reinterpreted as int32 words) instead of an all-reduce, and
each worker averages only itself and its neighbours with the uniform
Metropolis weight ``1/(degree+1)``.

Per round, per worker ``i`` with mixing row ``w_ij``:

1. select/encode ``acc_i = m_i + eta_i * g_i`` at the static budget —
   the bucketed transport's payload, byte for byte
   (:func:`repro_torch.core.leafmath.select_and_encode`);
2. exchange the buffer with the ``degree`` neighbours: per direction of
   ``topology.perms`` one isend to this rank's ``dst`` and one irecv
   from its ``src``, all in one ``dist.batch_isend_irecv``
   (``degree x payload`` bytes on each worker's uplink);
3. decode the own row and the received ones in one batched decode, form
   the consensus mix ``mix_i = sum_j w_ij decode(p_j)`` and the gossip
   error ``e_i = mix_i - decode(p_i)``;
4. EF residual exactly as the bucketed transport's:
   ``m_i' = acc_i - decode(p_i)``, so the EF memory and the byte counts
   equal bucketed's bit for bit on the same inputs;
5. the AdaGossip-style adaptive consensus step (arXiv 2404.05919, scalar
   variant): ``v' = beta v + (1-beta) mean(e_i^2)`` and
   ``lr_t = min(lr_max, consensus_lr / (sqrt(v') + eps))``;
6. this worker's update is ``decode(p_i) + lr_t * e_i``.

At one worker (``degree`` 0) no P2P operation is posted, the only row is
the own one and the mix is the identity: the round equals ``bucketed``
with no collective at all.

**Rounding, as jitted XLA computes the JAX twin.**  The dense mix
``sum / (deg+1)`` divides by a constant, which XLA turns into a product
with ``f32(1/(deg+1))`` and contracts with the subtraction of the own
accumulator: the dense gossip error is one fused multiply-add
(``torch.addcmul``).  The sparse mix under the default fault guards
divides each layer by its valid-row count, a traced value, so it stays a
true division (by ``deg+1`` on a clean payload); unguarded
(``comm.faults.guards_disabled``, ``--no-quarantine``) it divides by the
constant ``deg+1``, a product with ``f32(1/(deg+1))``.  ``err_sq /
n_tot`` is a product with ``f32(1/n_tot)``; ``beta*v + (1-beta)*x`` and
``own + lr_t*e`` are each one fused multiply-add (``torch.add`` with
``alpha``, ``torch.addcmul``).

**The §16 guards.**  The decode of the own and the received rows runs
the verdicts unless ``comm.faults.guards_active()`` is False: a
quarantined neighbour row adds nothing and leaves the mix over the valid
rows; a quarantined own row (slot 0) freezes the leaf's EF memory for the
round.  The ``rows_quarantined`` telemetry counts this worker's
quarantined rows.  The dense leaves carry no verdict, as in JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.bucket import decode_guarded, encode_buckets
from repro_torch.comm.exchange import check_bucket_payload
from repro_torch.comm.ring import _global_rank
from repro_torch.comm.topology import TOPOLOGIES, Topology
from repro_torch.comm.transport import register_transport
from repro_torch.core.dcsgd import _tree_plan, valid_row_mean
from repro_torch.core.leafmath import jax_index_rules, plan_wire_bytes, \
    scatter_pairs, select_and_encode
from repro_torch.core.telemetry import TelemetrySums, sparse_own_sums
from repro_torch.kernels.ref import ef_acc
from repro_torch.utils import tree_flatten, tree_unflatten

__all__ = [
    "GossipConfig",
    "GossipState",
    "GossipCtx",
    "neighbour_peers",
    "exchange_rows",
    "adagossip_step",
    "gossip_exchange",
    "gossip_mix",
]

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Static gossip/consensus hyper-parameters (``OptimizerConfig.gossip``).

    ``consensus_lr`` is the numerator of the adaptive consensus step;
    ``beta``/``eps`` shape the second-moment EMA of the gossip error;
    ``lr_max`` caps the step (the cap is what the fixed-step CHOCO-style
    baseline would use — with a tiny ``v`` the adaptive step saturates
    there instead of diverging).
    """

    topology: str = "ring"
    consensus_lr: float = 1.0
    beta: float = 0.9
    eps: float = 1e-8
    lr_max: float = 1.0

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            want = " | ".join(f"'{t}'" for t in sorted(TOPOLOGIES))
            raise ValueError(f"unknown topology {self.topology!r} "
                             f"(want {want})")
        if not 0.0 <= self.beta < 1.0:
            raise ValueError(f"gossip beta must be in [0, 1), "
                             f"got {self.beta}")
        for field in ("consensus_lr", "eps", "lr_max"):
            if getattr(self, field) <= 0.0:
                raise ValueError(f"gossip {field} must be > 0, "
                                 f"got {getattr(self, field)}")


@dataclasses.dataclass(frozen=True)
class GossipState:
    """Carried adaptive-consensus state of one worker: 0-dim f32 tensors
    on the working device, so the step's ``v'`` needs no host sync."""

    v: torch.Tensor     # EMA second moment of the gossip error
    lr: torch.Tensor    # last applied consensus step (reporting)

    @classmethod
    def init(cls, device=None) -> "GossipState":
        """Neutral start: zero moment — the first round's step is
        ``min(lr_max, consensus_lr / eps) -> lr_max`` for any sane eps."""
        def leaf():
            return torch.zeros((), dtype=torch.float32, device=device)
        return cls(v=leaf(), lr=leaf())


@dataclasses.dataclass(frozen=True)
class GossipCtx:
    """Everything the gossip exchange needs beyond the shared interface:
    the static topology and config, and this worker's carried state."""

    topology: Topology
    cfg: GossipConfig
    state: GossipState


def neighbour_peers(topo: Topology, rank: int) -> list[tuple[int, int]]:
    """``(dst, src)`` of ``rank`` for each direction of ``topo.perms``, in
    order: the worker it sends to and the one it receives from.  Every
    peer appears once per role (``_dedup`` leaves at most one direction
    per peer), so two messages between one pair never need tags."""
    out = []
    for perm in topo.perms:
        dst = [d for s, d in perm if s == rank]
        src = [s for s, d in perm if d == rank]
        out.append((dst[0], src[0]))
    dsts, srcs = [d for d, _ in out], [s for _, s in out]
    if len(set(dsts)) != len(dsts) or len(set(srcs)) != len(srcs) \
            or rank in dsts or rank in srcs:
        raise AssertionError(
            f"{topo.name}({topo.n}): rank {rank} has a repeated or self "
            f"peer in {out}")
    return out


def exchange_rows(buf: torch.Tensor, topo: Topology,
                  group=None) -> torch.Tensor:
    """``(degree+1, *buf.shape)``: the own ``buf`` first, then the row
    received in each direction of ``topo.perms``, as JAX's
    ``[buf] + [ppermute(buf, perm) for perm in perms]``.  One
    ``batch_isend_irecv`` posts every direction's send and receive, then
    waits them; ``buf`` is only read, and stays alive until the wait.
    Nothing is posted at degree 0."""
    rows = torch.empty((topo.degree + 1,) + tuple(buf.shape),
                       dtype=buf.dtype, device=buf.device)
    rows[0].copy_(buf)
    if topo.degree:
        rank = dist.get_rank(group)
        ops = []
        for d, (dst, src) in enumerate(neighbour_peers(topo, rank)):
            ops.append(dist.P2POp(dist.isend, buf,
                                  _global_rank(group, dst), group))
            ops.append(dist.P2POp(dist.irecv, rows[d + 1],
                                  _global_rank(group, src), group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return rows


def adagossip_step(cfg: GossipConfig, state: GossipState,
                   err_sq: torch.Tensor, n_tot: int) -> GossipState:
    """``v' = beta v + (1-beta) err_sq/n_tot`` and ``lr_t = min(lr_max,
    consensus_lr / (sqrt(v') + eps))``, rounded as jitted XLA rounds the
    JAX twin: ``err_sq/n_tot`` a product with ``f32(1/n_tot)``, then
    ``(1-beta)`` times it, then one fused multiply-add with ``beta v``."""
    mean = err_sq * float(f32(1.0) / f32(n_tot))
    v_new = torch.add(mean * float(f32(1.0 - cfg.beta)), state.v,
                      alpha=float(f32(cfg.beta)))
    denom = torch.sqrt(v_new) + float(f32(cfg.eps))
    step = torch.div(torch.full_like(denom, cfg.consensus_lr), denom)
    lr_t = torch.minimum(step, torch.full_like(step, cfg.lr_max))
    return GossipState(v=v_new, lr=lr_t)


@register_transport("gossip", stateful=True, description=(
    "serverless neighbor-ppermute exchange with Metropolis consensus "
    "averaging and an AdaGossip-style adaptive consensus step"))
def gossip_exchange(flat_g, flat_m, flat_s, eta, comp, group, gamma_t, *,
                    ctx: GossipCtx):
    """Steps 4-6 of Algorithm 3 with a gossip consensus round in place of
    the global mean — see the module docstring for the per-round math.
    Returns ``(updates, new_mem, wire, eff_wire, sums, new_state)``."""
    topo = ctx.topology
    W = dist.get_world_size(group)
    if topo.n != W:
        raise ValueError(f"topology {topo.name!r} is built for {topo.n} "
                         f"workers but the dp axis has {W}")
    deg = topo.degree
    device = flat_g[0].device
    plan = _tree_plan(flat_g, flat_s, comp)
    lanes = plan.leaves
    n = len(lanes)
    sel = select_and_encode(flat_g, flat_m, flat_s, eta, comp, gamma_t,
                            plan)

    # ---- ONE flat buffer: packed payload + the dense leaves' f32
    # accumulators as int32 words (gossip has no global collective, so
    # they ride the buffer and mix like everything else)
    dense_ids = list(plan.dense_ids)
    dense_acc = [None] * n
    for i in dense_ids:
        dense_acc[i] = ef_acc(flat_m[i], flat_g[i], eta).reshape(
            flat_g[i].shape)
    parts = []
    if plan.total_words:
        payload = encode_buckets(plan, sel.enc_rows)
        check_bucket_payload(payload, plan, comp)
        parts.append(payload)
    if dense_ids:
        parts.append(torch.cat([dense_acc[i].reshape(-1)
                                for i in dense_ids]).view(torch.int32))
    buf = parts[0] if len(parts) == 1 else torch.cat(parts)

    # ---- degree neighbour sends of the ONE buffer (own row first) -------
    all_rows = exchange_rows(buf, topo, group)       # (degree+1, words)

    decoded = verdicts = [None] * n
    if plan.total_words:
        decoded, verdicts = decode_guarded(plan,
                                           all_rows[:, :plan.total_words])
    dense_total = [None] * n
    if dense_ids:
        dcat = all_rows[:, plan.total_words:].view(torch.float32)
        # XLA's reduce from 0 in row order
        total = torch.zeros_like(dcat[0])
        for row in dcat:
            total = total + row
        off = 0
        for i in dense_ids:
            size = dense_acc[i].numel()
            dense_total[i] = total[off:off + size].reshape(
                dense_acc[i].shape)
            off += size
        # the mix's division by deg+1 is, jitted, a product with
        # f32(1/(deg+1)), which XLA contracts with the subtraction of
        # the own accumulator into one fused multiply-add
        inv = torch.full((), float(f32(1.0) / f32(deg + 1)),
                         dtype=torch.float32, device=device)

    # ---- per-leaf consumers, ORIGINAL tree order: EF residual and
    # telemetry as the bucketed transport's; wire bytes are PER LINK
    new_mem = [None] * n
    own_upd = [None] * n    # decode(own payload), dense f32
    gerr = [None] * n       # mix - decode(own): the consensus correction
    sums = TelemetrySums.zero(device)
    err_sq = torch.zeros((), dtype=torch.float32, device=device)
    n_tot = 0
    for lane, g, m in zip(lanes, flat_g, flat_m):
        i = lane.index
        if lane.dense:
            acc = dense_acc[i]
            own_upd[i] = acc
            gerr[i] = torch.addcmul(-acc, dense_total[i], inv)
            new_mem[i] = torch.zeros_like(m)
            sums = sums.add_dense(acc, g)
            err_sq = err_sq + (gerr[i] * gerr[i]).sum()
            n_tot += acc.numel()
            continue
        L, d = lane.L, lane.d
        g_vals, g_idx = decoded[i]                  # (degree+1, L, k)
        s_vals, s_idx = jax_index_rules(g_vals, g_idx, d)
        total = scatter_pairs(s_vals, s_idx, L, d)
        verdict, quar = verdicts[i], None
        if verdict is None:
            mix = total * float(f32(1.0) / f32(deg + 1))
        else:
            mix, quar = valid_row_mean(total, verdict)
        own_vals, own_idx = g_vals[0], g_idx[0]
        own_dense = scatter_pairs(s_vals[0], s_idx[0], L, d)
        e = mix - own_dense
        if sel.use_fused:
            r = sel.resid[i] + (sel.sent[i] - own_dense)
        else:
            r = sel.acc2[i] - own_dense
        if verdict is not None:
            # own row (slot 0) quarantined: freeze this leaf's EF
            r = torch.where(verdict[0][:, None], r, m.float().reshape(L, d))
        new_mem[i] = r.reshape(m.shape).to(m.dtype)
        own_upd[i], gerr[i] = own_dense, e
        own_sq, own_dot = sparse_own_sums(own_vals, own_idx, sel.g2f[i])
        sums = sums.add(g_sq=sel.leaf_g_sq[i], acc_sq=sel.leaf_acc_sq[i],
                        resid_sq=(r * r).sum(), own_sq=own_sq,
                        own_dot_g=own_dot, quar_rows=quar)
        err_sq = err_sq + (e * e).sum()
        n_tot += L * d

    # ---- AdaGossip adaptive consensus step (scalar second moment) -------
    new_state = adagossip_step(ctx.cfg, ctx.state, err_sq, n_tot)
    updates = []
    for lane, g in zip(lanes, flat_g):
        i = lane.index
        u = torch.addcmul(own_upd[i], new_state.lr, gerr[i])
        updates.append(u.reshape(g.shape))
    wire, eff_wire = plan_wire_bytes(plan, comp, gamma_t)
    return updates, new_mem, wire, eff_wire, sums, new_state


def gossip_mix(tree, topo: Topology, group=None, lr: float = 1.0):
    """One UNCOMPRESSED gossip round on a tree of this worker's values:

        x_i' = x_i + (lr / (degree+1)) * sum_{j in N(i)} (x_j - x_i)

    The difference form makes a constant tree a fixed point BIT-EXACTLY
    (every ``x_j - x_i`` is literally zero) and matches
    :meth:`Topology.mix_reference` term for term; ``x + w*acc`` is one
    fused multiply-add, as jitted XLA contracts it.  Used by the
    consensus contraction tests and as the plain-parameter-averaging
    building block."""
    w = float(f32(lr / (topo.degree + 1)))
    leaves, structure = tree_flatten(tree)
    out = []
    for x in leaves:
        rows = exchange_rows(x, topo, group)
        acc = None
        for nb in rows[1:]:
            delta = nb - x
            acc = delta if acc is None else acc + delta
        out.append(x if acc is None else torch.add(x, acc, alpha=w))
    return tree_unflatten(structure, out)
