"""Seeded hostile-wire fault injection and the ``faulty`` transport
wrapper (twin of ``src/repro/comm/faults.py``, DESIGN.md §16).

The wire format is only garbage-tolerant by construction (index and count
clamping); this module makes hostility a reproducible test axis.  A
:class:`FaultConfig` names per-class rates and a deterministic ``(seed,
step, lane, row)`` keying; the injector corrupts **gathered payload rows
at the wire boundary** — after the collective, before decode.  Fault
classes:

* ``bitflip``    — XOR one uniformly chosen bit of one uniformly chosen
  word of the row (header, scale, index or value words);
* ``count``      — replace a ragged count header with ``0xFFFFFFFF``
  (decodes to -1: truncated) or ``2*full_count + 7`` (overflowed);
* ``nonfinite``  — write NaN/Inf bit patterns into the first value word
  (f32/bf16 rows) or the quantization-scale word (8-/4-bit rows);
* ``zero_row``   — zero the whole row: a dropped worker.  An all-zero row
  decodes cleanly (count 0, scale 0, values 0), so the verdict layer
  does not quarantine it.

The draws are ``jax.random``'s threefry stream, reproduced bit for bit on
the host in NumPy (:func:`uniform`, :func:`randint`): the seed, the lane
and the step are host ints in the port, so the corruption of a row is
the same on the CPU and on the card, and the draws add no device work.
Only the per-row edits reach the device, each one indexed write (the
bitflip one indexed XOR), and only for the rows they hit.

``transport="faulty"`` (:func:`faulty_exchange`) takes a
:class:`FaultCtx` naming the wrapped inner transport and its own ctx and
runs the inner exchange inside :func:`active_faults`; the decode sites
(``comm/bucket.py``, the perleaf exchange) call :func:`maybe_corrupt`,
an identity that launches nothing when no campaign is active.

The **verdict layer** (``wire.row_verdict`` and ``quarantine_rows``) is
independent of injection and on by default: :func:`guards_active` is
False only inside :func:`guards_disabled` or when the active campaign
sets ``quarantine=False``.  The scopes are module-level stacks entered
eagerly around an exchange (JAX enters them while its exchange traces).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.comm.transport import get_transport, register_transport

_RATE_FIELDS = ("p_bitflip", "p_count", "p_nonfinite", "p_zero_row")

# f32 / packed-bf16-pair bit patterns for the nonfinite fault class
_F32_NAN = 0x7FC00000
_F32_INF = 0x7F800000
_BF16_NAN_PAIR = 0x7FC07FC0
_BF16_INF_PAIR = 0x7F807F80

u32 = np.uint32


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static, hashable description of one injection campaign.

    ``worker`` targets one slot of the gathered leading axis (the dp
    worker for all_gather transports, the ring slot for gossip — slot 0
    is self); ``-1`` targets every row.  ``start_step``/``n_steps`` bound
    the burst (``n_steps=-1``: open ended).  ``quarantine=False`` keeps
    injecting but disables the verdict layer — the "what if we had no
    guards" ablation arm.
    """

    seed: int = 0
    p_bitflip: float = 0.0
    p_count: float = 0.0
    p_nonfinite: float = 0.0
    p_zero_row: float = 0.0
    worker: int = -1
    start_step: int = 0
    n_steps: int = -1
    quarantine: bool = True

    def __post_init__(self):
        for f in _RATE_FIELDS:
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultConfig.{f} must be in [0, 1], "
                                 f"got {v!r}")
        if self.start_step < 0:
            raise ValueError("FaultConfig.start_step must be >= 0")

    @property
    def enabled(self) -> bool:
        """True iff any fault class has a nonzero rate."""
        return any(getattr(self, f) > 0.0 for f in _RATE_FIELDS)


@dataclasses.dataclass(frozen=True)
class FaultCtx:
    """``transport_ctx`` of the ``faulty`` wrapper transport: the
    campaign, the round index (a host int: ``TrainState.step``), and the
    wrapped inner transport (+ its own ctx when it is stateful)."""

    cfg: FaultConfig
    step: int
    inner: str
    inner_ctx: object = None


# ---------------------------------------------------------------------------
# the scopes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ActiveFaults:
    cfg: FaultConfig
    step: int


_ACTIVE: list[_ActiveFaults] = []
_GUARDS_OFF: list[bool] = []


@contextlib.contextmanager
def active_faults(cfg: FaultConfig, step):
    """Decode sites reached inside inject faults keyed on ``(cfg.seed,
    step, lane, row)``."""
    _ACTIVE.append(_ActiveFaults(cfg, int(step)))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def guards_disabled():
    """Disable the decode verdict/quarantine layer (the unguarded bench
    arm and the pinned no-quarantine divergence test)."""
    _GUARDS_OFF.append(True)
    try:
        yield
    finally:
        _GUARDS_OFF.pop()


def guards_active() -> bool:
    """Should decode sites compute verdicts and quarantine?  True by
    default; False inside :func:`guards_disabled` or when an active
    campaign opts out."""
    if _GUARDS_OFF:
        return False
    if _ACTIVE and not _ACTIVE[-1].cfg.quarantine:
        return False
    return True


def injection_active() -> bool:
    return bool(_ACTIVE) and _ACTIVE[-1].cfg.enabled


# ---------------------------------------------------------------------------
# jax.random's threefry stream on the host (jax_threefry_partitionable)
# ---------------------------------------------------------------------------

def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of uint32 counts ``(x1, x2)``
    under the key ``(k1, k2)``, as ``jax._src.prng`` computes it."""
    k1, k2 = u32(k1), u32(k2)
    ks = (k1, k2, k1 ^ k2 ^ u32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x1, np.uint32) + ks[0]
        y0 = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + y0
                y0 = (y0 << u32(r)) | (y0 >> u32(32 - r))
                y0 = x0 ^ y0
            x0 = x0 + ks[(i + 1) % 3]
            y0 = y0 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, y0


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``'s two words (32-bit seeds)."""
    return (u32(0), u32(int(seed) & 0xFFFFFFFF))


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in``: the hash of the count ``(0, data)``."""
    a, b = threefry2x32(key[0], key[1], [0], [int(data) & 0xFFFFFFFF])
    return (a[0], b[0])


def split(key, n: int = 2) -> list:
    """``jax.random.split(key, n)``: key i is the hash of ``(0, i)``,
    which is ``fold_in(key, i)``."""
    a, b = threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
    return [(a[i], b[i]) for i in range(n)]


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element: the hash of each element's flat index
    ``(hi, lo)``, its two output words XORed."""
    n = int(np.prod(shape))
    i = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key[0], key[1], (i >> 32).astype(np.uint32),
                        (i & 0xFFFFFFFF).astype(np.uint32))
    return (a ^ b).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32: 23 random
    mantissa bits under the exponent of 1.0, minus 1."""
    bits = (random_bits(key, shape) >> u32(9)) | u32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32)
                      - np.float32(1.0))


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws folded through the span in uint32 arithmetic."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = u32(maxval - minval) if maxval > minval else u32(1)
    with np.errstate(over="ignore"):
        mult = u32(u32(1 << 16) % span)
        mult = u32((mult * mult) % span)
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

def _i32(words) -> np.ndarray:
    """uint32 bit patterns as the int32 words the port's payload holds."""
    return np.asarray(words, np.uint32).view(np.int32)


def maybe_corrupt(rows: torch.Tensor, spec, lane: int,
                  rows_per_worker: int) -> torch.Tensor:
    """Corrupt gathered payload ``rows`` ((R, row_words) int32) per the
    active campaign; an identity (the same tensor, nothing launched) when
    none is active or no row is hit.

    The draws are JAX's: ``fold_in(fold_in(key(seed), lane), step)``,
    then ``uniform(key, (R, 6))``, ``split(key, 2)`` and one ``randint``
    from each half — deterministic in ``(seed, step, lane, row)``.
    ``rows_per_worker`` maps a row to its gathered slot (``row //
    rows_per_worker``) for ``cfg.worker`` targeting.  A hit row is edited
    in a copy: the input is never written.
    """
    if not _ACTIVE:
        return rows
    st = _ACTIVE[-1]
    cfg = st.cfg
    if not cfg.enabled:
        return rows
    step = st.step
    in_window = step >= cfg.start_step
    if cfg.n_steps >= 0:
        in_window &= step < cfg.start_step + cfg.n_steps
    if not in_window:
        # JAX draws and masks every hit off; the rows are the same
        return rows
    R, words = rows.shape
    key = fold_in(prng_key(cfg.seed), lane)
    key = fold_in(key, step)
    u = uniform(key, (R, 6))
    kf = split(key, 2)
    active = np.ones((R,), bool)
    if cfg.worker >= 0:
        active = np.arange(R) // rows_per_worker == cfg.worker

    edits = []          # (row ids, column ids or None, int32 words, xor)
    # -- bitflip: XOR one uniform bit of one uniform word ------------------
    if cfg.p_bitflip > 0.0:
        hit = active & (u[:, 0] < np.float32(cfg.p_bitflip))
        w_sel = randint(kf[0], (R,), 0, words)
        b_sel = randint(kf[1], (R,), 0, 32)
        r = np.flatnonzero(hit)
        edits.append((r, w_sel[r], _i32(u32(1) << b_sel[r].astype(
            np.uint32)), True))
    # -- count header: truncated (-1) or overflowed ------------------------
    if cfg.p_count > 0.0 and spec.ragged:
        hit = active & (u[:, 1] < np.float32(cfg.p_count))
        bad = np.where(u[:, 2] < np.float32(0.5), u32(0xFFFFFFFF),
                       u32(2 * spec.full_count + 7))
        r = np.flatnonzero(hit)
        edits.append((r, np.zeros_like(r), _i32(bad[r]), False))
    # -- nonfinite value/scale word ----------------------------------------
    if cfg.p_nonfinite > 0.0:
        hit = active & (u[:, 3] < np.float32(cfg.p_nonfinite))
        half = u[:, 4] < np.float32(0.5)
        if spec.value_bits <= 8:
            # poison the quantization scale: every dequantized value NaNs
            tw = spec.header_words - 1
            bad = np.where(half, u32(_F32_NAN), u32(_F32_INF))
        else:
            # poison the first value word (live whenever count >= 1)
            tw = spec.header_words + spec.index_words
            if spec.value_bits == 16:
                bad = np.where(half, u32(_BF16_NAN_PAIR),
                               u32(_BF16_INF_PAIR))
            else:
                bad = np.where(half, u32(_F32_NAN), u32(_F32_INF))
        r = np.flatnonzero(hit)
        edits.append((r, np.full_like(r, tw), _i32(bad[r]), False))
    # -- dropped worker: whole row zeroed (wins over the others) -----------
    if cfg.p_zero_row > 0.0:
        hit = active & (u[:, 5] < np.float32(cfg.p_zero_row))
        r = np.flatnonzero(hit)
        edits.append((r, None, None, False))

    edits = [e for e in edits if e[0].size]
    if not edits:
        return rows
    rows = rows.clone()
    dev = rows.device

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)
    for r, col, val, xor in edits:
        ri = on_dev(r, torch.int64)
        if col is None:
            rows[ri] = 0
            continue
        ci = on_dev(col, torch.int64)
        v = on_dev(val, torch.int32)
        if xor:
            rows[ri, ci] ^= v
        else:
            rows[ri, ci] = v
    return rows


# ---------------------------------------------------------------------------
# the wrapper transport
# ---------------------------------------------------------------------------

@register_transport(
    "faulty", stateful=True,
    description="fault-injection wrapper: runs the FaultCtx.inner "
                "transport with seeded wire corruption active (§16)")
def faulty_exchange(flat_g, flat_m, flat_s, eta, comp, group, gamma_t, *,
                    ctx: FaultCtx):
    """Run ``ctx.inner``'s exchange inside the injection scope.

    A stateless inner transport is padded with an empty ``()`` carried
    state, so the wrapper keeps the stateful 6-tuple arity.
    """
    if ctx.inner == "faulty":
        raise ValueError("faulty transport cannot wrap itself")
    inner = get_transport(ctx.inner)
    with active_faults(ctx.cfg, ctx.step):
        if inner.stateful:
            if ctx.inner_ctx is None:
                raise ValueError(
                    f"faulty wrapper around stateful transport "
                    f"{ctx.inner!r} needs FaultCtx.inner_ctx")
            return inner.exchange(flat_g, flat_m, flat_s, eta, comp,
                                  group, gamma_t, ctx=ctx.inner_ctx)
        out = inner.exchange(flat_g, flat_m, flat_s, eta, comp, group,
                             gamma_t)
        return (*out, ())
