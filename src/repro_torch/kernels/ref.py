"""Plain PyTorch versions of the hand-written kernels — the CPU path and
the oracle the CUDA kernels are held against on the card.

Twins of the jnp oracles in ``src/repro/kernels/ref.py``, bit for bit
where those are bit-exact.  Two conventions differ from the JAX package,
both forced by PyTorch:

* ``acc = m + eta*g`` is formed with ``torch.addcmul``, which rounds once
  like the fused multiply-add the JAX reference compiles to; ``m + eta*g``
  written out rounds twice and differs in the last bit.
* Wire fields and words are uint32 bit patterns carried in ``int32``
  tensors: torch's ``uint32`` has no shifts or comparisons on the CPU.
  Shifts widen to int64 and fold back to the int32 bit pattern.
"""
from __future__ import annotations

import torch

_U32 = 1 << 32


def ef_acc(m: torch.Tensor, g: torch.Tensor,
           eta: torch.Tensor) -> torch.Tensor:
    """``m + eta*g`` in f32 with one rounding; eta is a 1-element tensor."""
    return torch.addcmul(m.float(), eta.float().reshape(1, 1), g.float())


def ef_block_update(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                    tau: torch.Tensor):
    """Per-block-row EF threshold split.  m, g: (R, C); tau: (R, 1).
    Returns (sent, m') in m's dtype; ``sent + m' == m + eta*g`` exactly."""
    sent, rest = threshold_split(ef_acc(m, g, eta), tau)
    return sent.to(m.dtype), rest.to(m.dtype)


def _kth_largest(mag: torch.Tensor, k_b: int) -> torch.Tensor:
    """Per-row k_b-th largest of ``mag`` (R, C) -> (R, 1), NaN for a row
    holding any NaN.  The JAX kernel knocks out one maximum per round and
    its max propagates NaN, so such a row's tau is NaN; ``torch.topk``
    would rank NaN as the largest value and return a finite tau."""
    tau = torch.topk(mag, k_b, dim=-1).values[:, -1:]
    return torch.where(mag.isnan().any(-1, keepdim=True),
                       torch.full_like(tau, float("nan")), tau)


def block_abs_topk_threshold(x: torch.Tensor, k_b: int) -> torch.Tensor:
    """Per-block-row k_b-th largest |x|.  x: (R, C) block rows, computed
    in f32 -> (R, 1) f32."""
    return _kth_largest(x.float().abs(), k_b)


def ef_block_stats(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                   k_b: int) -> torch.Tensor:
    """Per-block-row k_b-th largest |m + eta*g|.  (R, C) -> (R, 1) f32."""
    return _kth_largest(ef_acc(m, g, eta).abs(), k_b)


def ef_block_stats_telemetry(m: torch.Tensor, g: torch.Tensor,
                             eta: torch.Tensor, k_b: int):
    """Per-block-row k_b-th largest |m + eta*g| and the moments
    [sum g^2, sum acc^2].  (R, C) -> (tau (R, 1), moments (R, 2)) f32."""
    gf = g.float()
    acc = ef_acc(m, gf, eta)
    tau = _kth_largest(acc.abs(), k_b)
    moments = torch.stack([(gf * gf).sum(-1), (acc * acc).sum(-1)], dim=-1)
    return tau, moments


def threshold_split(x: torch.Tensor, tau: torch.Tensor):
    """Per-block-row dense split.  x: (R, C); tau: (R, 1).  Returns
    (sent, residual) in x's dtype; ``sent + residual == x`` exactly."""
    xf = x.float()
    mask = xf.abs() >= tau.reshape(-1, 1).float()
    sent = torch.where(mask, xf, torch.zeros((), dtype=xf.dtype,
                                             device=xf.device))
    return sent.to(x.dtype), (xf - sent).to(x.dtype)


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same 32 bits as int32."""
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


def to_u32_value(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & (_U32 - 1)


def _count_mask(R: int, n: int, counts: torch.Tensor,
                period: int) -> torch.Tensor:
    """(R, n) ragged validity: field j of a row is valid iff
    ``j % period < count`` (per-block prefix for block-local rows)."""
    pos = torch.arange(n, device=counts.device) % period
    return pos[None, :] < counts.to(torch.int64).reshape(-1, 1)


def pack_fields(fields: torch.Tensor, bits: int,
                counts: torch.Tensor | None = None,
                period: int = 0) -> torch.Tensor:
    """Pack (R, n) fields into (R, n*bits/32) words, field f of a word at
    bits [f*bits, (f+1)*bits).  n must be a multiple of 32 // bits.  With
    ``counts``, fields with ``j % period >= counts[row]`` are zeroed."""
    fields = fields.to(torch.int32)
    R, n = fields.shape
    if counts is not None:
        fields = torch.where(_count_mask(R, n, counts, period), fields, 0)
    if bits >= 32:
        return fields
    F = 32 // bits
    w = (to_u32_value(fields) & ((1 << bits) - 1)).reshape(R, n // F, F)
    shifts = torch.arange(F, device=fields.device, dtype=torch.int64) * bits
    return to_i32_bits((w << shifts).sum(-1))


def unpack_fields(words: torch.Tensor, bits: int,
                  counts: torch.Tensor | None = None,
                  period: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_fields`: (R, W) words -> (R, W*32/bits)
    fields; fields beyond the per-row count come out 0."""
    words = words.to(torch.int32)
    R, W = words.shape
    if bits >= 32:
        fields = words
    else:
        F = 32 // bits
        shifts = torch.arange(F, device=words.device,
                              dtype=torch.int64) * bits
        fields = ((to_u32_value(words)[:, :, None] >> shifts)
                  & ((1 << bits) - 1)).reshape(R, W * F).to(torch.int32)
    if counts is not None:
        fields = torch.where(
            _count_mask(R, fields.shape[1], counts, period), fields, 0)
    return fields


# --------------------------- flash attention -------------------------------

def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  q_offset: int | None = None) -> torch.Tensor:
    """Multi-head attention.  q: (B, H, Sq, D); k, v: (B, H, Sk, D).
    ``window``: sliding-window size (None = full); ``q_offset``: absolute
    position of the first query (default Sk - Sq, the trailing
    positions).  Logits and softmax in f32, the product scaled after it;
    returns (B, H, Sq, D) in q.dtype."""
    Sq, D = q.shape[-2:]
    Sk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if q_offset is None:
        q_offset = Sk - Sq
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# --------------------------- rmsnorm ----------------------------------------

def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """(x * rsqrt(mean(x^2) + eps)) * w over the last axis, in f32;
    returns x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# --------------------------- rwkv wkv ---------------------------------------

def wkv_reference(r, k, v, w, u, s0):
    """The RWKV-6 WKV recurrence, one step at a time, in f32.
    r, k, w: (B, S, H, K); v: (B, S, H, V); u: (H, K); s0: (B, H, K, V).
    Per step: y_t = r_t (S + diag(u) k_t^T v_t), S <- diag(w_t) S +
    k_t^T v_t.  Returns (y (B, S, H, V), sT (B, H, K, V))."""
    S_state = s0.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               S_state + uf * kv))
        S_state = w[:, t].float()[..., None] * S_state + kv
    return torch.stack(ys, dim=1), S_state
