"""RWKV-6 "Finch" block (twin of ``src/repro/models/rwkv.py``) —
attention-free linear-recurrence time mixing with data-dependent decay,
plus channel mixing.  [arXiv:2404.05892]

Per head (hd = head size), per token:

    S_t  = diag(w_t) S_{t-1} + k_t^T v_t        (S: (hd_k, hd_v))
    y_t  = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w_base + lora_w(x_t))) and token-shift ddlerp mixing
for the r/k/v/w/g projections.  The recurrence is ``ops.wkv``: the WKV
kernel for CUDA tensors when ``cfg.use_pallas``, else the plain step
loop, which is what the JAX package's ``lax.scan`` computes.  Prefill
and decode are the same code (decode with L = 1).  ``mu``, ``w_base``,
``u``, ``ln_w``, ``ln_b`` and ``mu_cm`` stay f32 whatever the param
dtype, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F_

from repro_torch.kernels import ops
from .layers import he_init

MIX = ("r", "k", "v", "w", "g")


class RWKVState(NamedTuple):
    tm_prev: torch.Tensor   # (B, D) last token entering time-mix, f32
    cm_prev: torch.Tensor   # (B, D) last token entering channel-mix, f32
    wkv: torch.Tensor       # (B, H, hd, hd) recurrent state, f32


def _dims(cfg):
    hd = cfg.hd
    return cfg.d_model // hd, hd


def init_rwkv6(gen, cfg, dtype, lead=()):
    """JAX's ``init_rwkv6`` with ``lead`` stacked layer axes."""
    D = cfg.d_model
    H, hd = _dims(cfg)
    r = cfg.rwkv_lora_rank
    lead = tuple(lead)
    dev = gen.device
    f32 = torch.float32

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=f32, device=dev)

    return {
        "mu": {c: full((D,), 0.5) for c in MIX},
        "lora_A": {c: he_init(gen, (D, r), dtype, lead=lead) for c in MIX},
        "lora_B": {c: torch.zeros(lead + (r, D), dtype=dtype, device=dev)
                   for c in MIX},
        "wr": {"w": he_init(gen, (D, D), dtype, lead=lead)},
        "wk": {"w": he_init(gen, (D, D), dtype, lead=lead)},
        "wv": {"w": he_init(gen, (D, D), dtype, lead=lead)},
        "wg": {"w": he_init(gen, (D, D), dtype, lead=lead)},
        "wo": {"w": he_init(gen, (D, D), dtype, lead=lead)},
        "w_base": full((D,), -2.0),
        "u": 0.1 * torch.randn(lead + (H, hd), generator=gen, device=dev),
        "ln_w": full((D,), 1.0),
        "ln_b": full((D,), 0.0),
        "cm_k": {"w": he_init(gen, (D, cfg.d_ff), dtype, lead=lead)},
        "cm_v": {"w": he_init(gen, (cfg.d_ff, D), dtype, lead=lead)},
        "mu_cm": full((D,), 0.5),
    }


def _ddlerp(p, c, x, xx):
    """Data-dependent lerp between x and the shifted xx for channel c."""
    mix = p["mu"][c] + torch.tanh(x @ p["lora_A"][c].to(x.dtype)) \
        @ p["lora_B"][c].to(x.dtype)
    return x + (xx - x) * mix.to(x.dtype)


def _group_norm(y, w, b, H, hd, eps=1e-5):
    """Per-head layer norm of a (..., H * hd) output, in f32."""
    shape = y.shape
    yr = y.reshape(*shape[:-1], H, hd).float()
    mean = yr.mean(-1, keepdim=True)
    c = yr - mean
    var = (c * c).mean(-1, keepdim=True)
    yr = c * torch.rsqrt(var + eps)
    return yr.reshape(shape) * w + b


def time_mix(p, x, cfg, state: RWKVState):
    """x: (B, L, D).  Returns (y, new state)."""
    B, L, D = x.shape
    H, hd = _dims(cfg)
    xx = torch.cat([state.tm_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = (_ddlerp(p, c, x, xx) for c in MIX)

    r = (xr @ p["wr"]["w"].to(x.dtype)).reshape(B, L, H, hd)
    k = (xk @ p["wk"]["w"].to(x.dtype)).reshape(B, L, H, hd)
    v = (xv @ p["wv"]["w"].to(x.dtype)).reshape(B, L, H, hd)
    g = F_.silu(xg @ p["wg"]["w"].to(x.dtype))

    # data-dependent decay (B, L, H, hd) in (0, 1)
    wdec = p["w_base"] + (torch.tanh(xw @ p["lora_A"]["w"].to(x.dtype))
                          @ p["lora_B"]["w"].to(x.dtype)).float()
    wdec = torch.exp(-torch.exp(wdec)).reshape(B, L, H, hd)

    y4, s_final = ops.wkv(r.float(), k.float(), v.float(), wdec, p["u"],
                          state.wkv, use_kernel=cfg.use_pallas)
    y = y4.reshape(B, L, D)
    y = _group_norm(y, p["ln_w"], p["ln_b"], H, hd).to(x.dtype) * g
    out = y @ p["wo"]["w"].to(x.dtype)
    return out, state._replace(tm_prev=x[:, -1].float(), wkv=s_final)


def channel_mix(p, x, state: RWKVState):
    xx = torch.cat([state.cm_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xk = x + (xx - x) * p["mu_cm"].to(x.dtype)
    h = torch.square(torch.relu(xk @ p["cm_k"]["w"].to(x.dtype)))
    y = h @ p["cm_v"]["w"].to(x.dtype)
    return y, state._replace(cm_prev=x[:, -1].float())


def init_rwkv_state(cfg, B: int, device="cpu") -> RWKVState:
    H, hd = _dims(cfg)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return RWKVState(tm_prev=z(B, cfg.d_model), cm_prev=z(B, cfg.d_model),
                     wkv=z(B, H, hd, hd))
