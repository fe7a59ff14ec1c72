"""Mamba2 (SSD) block (twin of ``src/repro/models/ssm.py``) — chunked
parallel scan for train/prefill, O(1)-state recurrence for decode.
[Dao & Gu '24, as used by Zamba2, arXiv:2411.15242]

State-space semantics per head h with scalar decay A_h < 0:

    dA_t = exp(dt_t * A)                  (per-token decay)
    S_t  = dA_t * S_{t-1} + dt_t * B_t (x) x_t     (S: (hd, N))
    y_t  = C_t . S_t + D_skip * x_t

Train/prefill uses the chunked formulation: an intra-chunk quadratic
term and an inter-chunk state recurrence over ``seq/chunk`` steps, in
plain PyTorch (the JAX package has no Pallas kernel for it).  The op
order is JAX's: the f32 conv taps added in order 0..K-1 and then the
bias, ``softplus`` of ``dt + dt_bias`` in f32 as JAX's ``logaddexp``
writes it, the intra-chunk decay masked in log space before ``exp``,
and a Python loop over the chunks where JAX has ``lax.scan``.  The
gated norm (its gate ``y * silu(z)`` formed in f32 and rounded once)
gets ``cfg.use_pallas`` like every RMSNorm of the port, so serving
reaches the RMSNorm kernel's wide body (d_in = 7168 at zamba2-7b).
``A_log``, ``D_skip`` and ``dt_bias`` stay f32 whatever the param
dtype, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F_

from .layers import he_init, rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_conv_in)  rolling conv window
    ssm: torch.Tensor    # (B, H, hd, N)        recurrent state, f32


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


def init_mamba2(gen, cfg, dtype, lead=()):
    """JAX's ``init_mamba2`` with ``lead`` stacked layer axes."""
    D = cfg.d_model
    d_in, nh, N, _ = _dims(cfg)
    d_conv_in = d_in + 2 * N
    lead = tuple(lead)
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": {"w": he_init(gen, (D, 2 * d_in + 2 * N + nh), dtype,
                                 lead=lead)},
        "conv_w": (torch.randn(lead + (cfg.ssm_conv, d_conv_in),
                               generator=gen, device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (d_conv_in,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=dev)).expand(
            lead + (nh,)).contiguous(),
        "D_skip": torch.ones(lead + (nh,), dtype=f32, device=dev),
        "dt_bias": torch.zeros(lead + (nh,), dtype=f32, device=dev),
        "norm": {"w": torch.ones(lead + (d_in,), dtype=dtype, device=dev)},
        "out_proj": {"w": he_init(gen, (d_in, D), dtype, lead=lead)},
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gate(y, z):
    """``y * silu(z)`` in y's type, formed in f32 and rounded once, as
    XLA evaluates the fused bf16 product (PyTorch alone would round
    silu(z) to bf16 before the product)."""
    return (y.float() * F_.silu(z.float())).to(y.dtype)


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv over seq. xBC: (B, L, Cc); w: (K, Cc).

    If ``state`` (B, K-1, Cc) is given, it is the rolling history (decode /
    chunked prefill continuation); returns (out, new_state).  Unrolled f32
    taps, as JAX writes them (an f32 ``F.conv1d`` on the card would run
    through cuDNN in TF32)."""
    B, L, Cc = xBC.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, Cc), dtype=xBC.dtype,
                            device=xBC.device)
    full = torch.cat([state.to(xBC.dtype), xBC], dim=1)   # (B, L+K-1, Cc)
    out = torch.zeros((B, L, Cc), dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + full[:, i:i + L].float() * w[i].float()
    out = out + b.float()
    new_state = full[:, L:]
    return F_.silu(out).to(xBC.dtype), new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H); A: (H,) (negative); Bm, Cm: (B, L, N).
    Returns (y: (B, L, H, P) f32, final_state: (B, H, P, N) f32).  Raises
    ``ValueError`` where JAX's assert fails: L // max(1, L // chunk)
    chunks of equal length must cover L."""
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = max(1, L // chunk)
    cl = L // nc
    if nc * cl != L:
        raise ValueError(
            f"ssd_chunked: (L, chunk) = ({L}, {chunk}): {nc} chunks of "
            f"{cl} cover {nc * cl} of the {L} positions (the JAX package "
            "asserts the same)")
    f32 = torch.float32
    xr = x.reshape(Bb, nc, cl, H, P)
    dtr = dt.reshape(Bb, nc, cl, H)
    Br = Bm.reshape(Bb, nc, cl, N).to(f32)
    Cr = Cm.reshape(Bb, nc, cl, N).to(f32)

    dA = dtr * A                                   # (B, nc, cl, H), negative
    cum = torch.cumsum(dA, dim=2)                  # within-chunk log decay
    total = cum[:, :, -1:, :]                      # (B, nc, 1, H)

    dx = (dtr[..., None] * xr).to(f32)             # dt * x

    # intra-chunk: y[i] += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dx_j,
    # masked in log space BEFORE exp: exp(positive) for j > i would
    # overflow and poison the backward pass with inf*0 = nan
    li = cum[:, :, :, None, :]                     # (B,nc,cl_i,1,H)
    lj = cum[:, :, None, :, :]                     # (B,nc,1,cl_j,H)
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    logdecay = torch.where(mask, li - lj, torch.tensor(-1e30, dtype=f32,
                                                       device=x.device))
    decay = torch.exp(logdecay)                    # (B,nc,i,j,H)
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)   # (B,nc,i,j)
    att = cb[..., None] * decay                    # (B,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, dx)

    # chunk-final states: S_c = sum_j exp(total - cum_j) B_j (x) dx_j
    sdecay = torch.exp(total - cum)                # (B,nc,cl,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", sdecay, Br, dx)

    # inter-chunk recurrence: S = exp(total_c) * S_prev + S_chunk, with
    # the state ENTERING each chunk kept for the chunk's output
    tot_t = torch.exp(total[:, :, 0, :])           # (B, nc, H)
    S = init_state.to(f32) if init_state is not None else \
        torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
    enter = []
    for c in range(nc):
        enter.append(S)
        S = S * tot_t[:, c, :, None, None] + s_chunk[:, c]
    S_enter = torch.stack(enter, dim=1)            # (B, nc, H, P, N)

    # inter-chunk contribution: y[i] += exp(cum_i) * C_i . S_enter
    y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum), Cr,
                           S_enter)
    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    return y, S


def mamba2_block(p, x, cfg, state: SSMState | None = None,
                 return_state: bool = False):
    """x: (B, L, D) -> (y, new_state|None). Full-sequence path."""
    B, L, _ = x.shape
    d_in, nh, N, hd = _dims(cfg)
    proj = x @ p["in_proj"]["w"].to(x.dtype)
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * N, nh], dim=-1)
    conv_state = state.conv if state is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, L, nh, hd)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, S = ssd_chunked(xs, dt, A, Bm, Cm, min(cfg.ssm_chunk, L),
                       init_state=state.ssm if state is not None else None)
    y = y + p["D_skip"][None, None, :, None] * xs.float()
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = rms_norm(p["norm"], _gate(y, z), cfg.norm_eps, cfg.use_pallas)
    out = y @ p["out_proj"]["w"].to(x.dtype)
    if return_state:
        return out, SSMState(conv=new_conv, ssm=S)
    return out, None


def mamba2_decode(p, x, state: SSMState, cfg):
    """One-token recurrence. x: (B, 1, D). Returns (y, new_state)."""
    B = x.shape[0]
    d_in, nh, N, hd = _dims(cfg)
    proj = x @ p["in_proj"]["w"].to(x.dtype)
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * N, nh], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], state.conv)
    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, nh, hd)
    dt = _softplus(dt.float() + p["dt_bias"])[:, 0]          # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                    # (B, H)
    dx = dt[..., None] * xs.float()                           # (B, H, P)
    S = state.ssm * dA[..., None, None] + \
        torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), dx)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), S)
    y = y + p["D_skip"][None, :, None] * xs.float()
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(p["norm"], _gate(y, z), cfg.norm_eps, cfg.use_pallas)
    out = y @ p["out_proj"]["w"].to(x.dtype)
    return out, SSMState(conv=new_conv, ssm=S)


def init_ssm_state(cfg, B: int, dtype, device="cpu") -> SSMState:
    d_in, nh, N, hd = _dims(cfg)
    return SSMState(
        conv=torch.zeros((B, cfg.ssm_conv - 1, d_in + 2 * N), dtype=dtype,
                         device=device),
        ssm=torch.zeros((B, nh, hd, N), dtype=torch.float32, device=device))
