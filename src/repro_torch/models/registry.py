"""Model registry (twin of ``src/repro/models/registry.py``): one uniform
API over the port's decoder-only families (the vlm among them, in
``lm.py``) and its encoder-decoder.

``build_model(cfg)`` returns a ``Model`` with ``init / loss / prefill /
decode_step / init_cache / stacked_mask``; the serving launcher, the
trainer and the tests go through this object.  ``prefill``,
``decode_step`` and ``init_cache`` take a ``mesh=`` keyword
(:mod:`repro_torch.launch.mesh`), which the server passes to serve a
rank's slices of the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import encdec, lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[..., Any]
    stacked_mask: Callable[[Any], Any]


def build_model(cfg) -> Model:
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda seed=0, **kw: encdec.init_params(cfg, seed, **kw),
            loss=lambda p, b: encdec.loss_fn(p, b, cfg),
            prefill=lambda p, b, **kw: encdec.prefill(p, b, cfg, **kw),
            decode_step=lambda p, t, c, n, **kw: encdec.decode_step(
                p, t, c, n, cfg, **kw),
            init_cache=lambda B, capacity, s_enc=None, device="cpu",
            mesh=None: encdec.init_cache(cfg, B, capacity, s_enc or capacity,
                                         device),
            # JAX's registry gives the encoder-decoder lm.stacked_mask,
            # which marks none of its leaves
            stacked_mask=lm.stacked_mask,
        )
    return Model(
        cfg=cfg,
        init=lambda seed=0, **kw: lm.init_params(cfg, seed, **kw),
        loss=lambda p, b: lm.loss_fn(p, b, cfg),
        prefill=lambda p, b, **kw: lm.prefill(p, b, cfg, **kw),
        decode_step=lambda p, t, c, n, **kw: lm.decode_step(p, t, c, n, cfg,
                                                            **kw),
        init_cache=lambda B, capacity, device="cpu", mesh=None:
            lm.init_cache(cfg, B, capacity, device, mesh),
        stacked_mask=lm.stacked_mask,
    )
