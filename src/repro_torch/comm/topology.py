"""Gossip topologies: static mixing matrices and neighbour schedules
(twin of ``src/repro/comm/topology.py``, DESIGN.md §12).

The gossip transport (``repro_torch/comm/gossip.py``) replaces the
flat ``all_gather`` with point-to-point sends along the edges of a fixed
communication graph.  This module builds that graph as pure
Python/NumPy: a :class:`Topology` is a set of *neighbour directions*,
each a full permutation of the ``n`` workers (circulant shifts for
ring/exponential graphs, row/column shifts for the torus), so one
send/receive pair per worker and direction delivers every worker's
payload to exactly one neighbour.

Mixing weights are uniform Metropolis weights on the resulting
``degree``-regular graph: ``W_ij = 1/(degree+1)`` for every edge and for
the self loop.  Every constructor checks, at build time, that the
resulting matrix is symmetric, doubly stochastic, and (for ``n > 1``)
has a strictly positive spectral gap — a broken topology fails before
any exchange runs.  The perms, their order and the error texts are the
JAX package's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Perm = tuple[tuple[int, int], ...]   # ((src, dst), ...) — one direction


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fixed gossip graph over ``n`` workers.

    ``perms`` holds one full ``(src, dst)`` permutation per neighbor
    direction; deduplicated, so ``degree == len(perms)`` distinct
    neighbors per worker (the graphs here are vertex-transitive, so the
    degree is uniform).  ``n == 1`` is the degenerate self-only graph
    (used by single-worker benches); it has no edges and mixing is the
    identity.
    """

    name: str
    n: int
    perms: tuple[Perm, ...]

    @property
    def degree(self) -> int:
        return len(self.perms)

    @property
    def mix_weight(self) -> float:
        """Uniform Metropolis weight of every edge and the self loop."""
        return 1.0 / (self.degree + 1)

    def neighbors(self, i: int) -> tuple[int, ...]:
        """Workers whose payload worker ``i`` receives (one per perm)."""
        out = []
        for perm in self.perms:
            for src, dst in perm:
                if dst == i:
                    out.append(src)
        return tuple(out)

    def mixing_matrix(self) -> np.ndarray:
        """The (n, n) float64 doubly-stochastic mixing matrix ``M``:
        ``M[i, j]`` is the weight of worker ``j``'s value in worker
        ``i``'s mix — ``(I + sum_d P_d) / (degree + 1)`` with
        ``P_d[dst, src] = 1`` for direction ``d``."""
        m = np.eye(self.n, dtype=np.float64)
        for perm in self.perms:
            for src, dst in perm:
                m[dst, src] += 1.0
        return m / (self.degree + 1)

    def mix_reference(self, z, lr: float = 1.0):
        """Collective-free reference of ONE gossip round on stacked
        per-worker values ``z`` with shape ``(n, ...)``:

            z_i' = z_i + (lr / (degree+1)) * sum_j in N(i) (z_j - z_i)

        Written in the difference form so a constant ``z`` is a fixed
        point BIT-EXACTLY (every ``z_j - z_i`` is literally zero) — the
        same form :func:`repro_torch.comm.gossip.gossip_mix` uses on the
        process group.  Works on NumPy arrays and torch tensors alike
        (pure indexing/arithmetic).
        """
        acc = None
        for perm in self.perms:
            src = np.empty(self.n, dtype=np.int64)
            for s, d in perm:
                src[d] = s
            if not isinstance(z, np.ndarray):
                src = torch.as_tensor(src, device=z.device)
            delta = z[src] - z
            acc = delta if acc is None else acc + delta
        if acc is None:
            return z
        w = np.asarray(lr / (self.degree + 1), dtype=np.asarray(z).dtype) \
            if isinstance(z, np.ndarray) else lr / (self.degree + 1)
        return z + w * acc

    def spectral_gap(self) -> float:
        """``1 - max_{lambda != 1} |lambda(M)|`` (0 for ``n == 1``)."""
        if self.n == 1:
            return 0.0
        lam = np.linalg.eigvalsh(self.mixing_matrix())
        return float(1.0 - max(abs(lam[0]), abs(lam[-2])))


def _shift_perm(n: int, s: int) -> Perm:
    """Circulant shift: worker ``i`` sends to ``(i + s) mod n``."""
    return tuple((i, (i + s) % n) for i in range(n))


def _checked(topo: Topology) -> Topology:
    """Build-time invariants: perms are permutations, matrix symmetric,
    doubly stochastic, spectral gap > 0 (connected, non-bipartite-safe
    thanks to the self loop weight)."""
    for perm in topo.perms:
        srcs = {s for s, _ in perm}
        dsts = {d for _, d in perm}
        if srcs != set(range(topo.n)) or dsts != set(range(topo.n)):
            raise ValueError(f"{topo.name}: direction is not a "
                             f"permutation of {topo.n} workers: {perm}")
    m = topo.mixing_matrix()
    if not np.array_equal(m, m.T):
        raise ValueError(f"{topo.name}({topo.n}): mixing matrix is not "
                         f"symmetric")
    ones = np.ones(topo.n)
    if not (np.allclose(m @ ones, ones) and np.allclose(ones @ m, ones)):
        raise ValueError(f"{topo.name}({topo.n}): mixing matrix is not "
                         f"doubly stochastic")
    if topo.n > 1 and topo.n <= 4096 and topo.spectral_gap() <= 0.0:
        raise ValueError(f"{topo.name}({topo.n}): zero spectral gap — "
                         f"gossip would not mix")
    return topo


def _dedup(perms: list[Perm]) -> tuple[Perm, ...]:
    seen, out = set(), []
    for p in perms:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return tuple(out)


def ring(n: int) -> Topology:
    """Bidirectional ring: neighbors at +-1 (degree 2; 1 for ``n <= 2``)."""
    if n < 1:
        raise ValueError(f"ring: need n >= 1, got {n}")
    perms = [] if n == 1 else _dedup([_shift_perm(n, 1), _shift_perm(n, -1)])
    return _checked(Topology("ring", n, perms))


def _torus_dims(n: int) -> tuple[int, int]:
    """Largest factor pair r x c with r <= c (r as close to sqrt(n) as
    the factorization allows)."""
    r = int(math.isqrt(n))
    while r > 1 and n % r:
        r -= 1
    return r, n // r


def torus(n: int) -> Topology:
    """2-D torus on an ``r x c`` factorization of ``n`` (row-major):
    neighbors at +-1 within the row (wraparound at ``c``) and +-1 across
    rows (circulant shift by ``c``).  ``n`` prime degrades to a ring."""
    if n < 1:
        raise ValueError(f"torus: need n >= 1, got {n}")
    if n == 1:
        return _checked(Topology("torus", 1, ()))
    r, c = _torus_dims(n)
    if r == 1:
        return _checked(Topology("torus", n,
                                 _dedup([_shift_perm(n, 1),
                                         _shift_perm(n, -1)])))

    def row_shift(s: int) -> Perm:
        return tuple((i * c + j, i * c + (j + s) % c)
                     for i in range(r) for j in range(c))

    perms = _dedup([row_shift(1), row_shift(-1),
                    _shift_perm(n, c), _shift_perm(n, -c)])
    return _checked(Topology("torus", n, perms))


def exp_graph(n: int) -> Topology:
    """Symmetric (static) exponential graph: neighbors at +-2**j hops for
    ``2**j < n`` — O(log n) degree, O(log n)-step information spread."""
    if n < 1:
        raise ValueError(f"exp: need n >= 1, got {n}")
    perms: list[Perm] = []
    j = 1
    while j < n:
        perms += [_shift_perm(n, j), _shift_perm(n, -j)]
        j *= 2
    return _checked(Topology("exp", n, _dedup(perms)))


#: Name -> constructor; the single source of truth for ``--topology``.
TOPOLOGIES = {"ring": ring, "torus": torus, "exp": exp_graph}


def build_topology(name: str, n: int) -> Topology:
    try:
        make = TOPOLOGIES[name]
    except KeyError:
        want = " | ".join(f"'{t}'" for t in sorted(TOPOLOGIES))
        raise ValueError(f"unknown topology {name!r} (want {want})") \
            from None
    return make(n)
