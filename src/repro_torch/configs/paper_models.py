"""The paper's experiment models (twin of
``src/repro/configs/paper_models.py``): the MLP and CNN classifier
stand-ins and the ~100M dense LM of the end-to-end training runs.

The nets keep the JAX package's layouts at their public functions: images
are NHWC (B, 32, 32, 3) and conv kernels HWIO (3, 3, C_in, C_out).
Compression and the int8 EF memory flatten each parameter leaf, so the
layout decides which entries share a 1024-wide block, which of two equal
magnitudes comes first and which 256 values share an int8 scale; kept
as in JAX, a CSGD step on the CNN is comparable entry for entry.  The
forward permutes to NCHW/OIHW only around ``conv2d``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F_

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class PaperNetConfig:
    name: str
    kind: str                  # mlp | cnn
    in_dim: int = 3072         # 32*32*3
    n_classes: int = 100
    widths: tuple = (512, 512)
    channels: tuple = (32, 64, 128)


MLP_CONFIG = PaperNetConfig(name="paper-mlp", kind="mlp")
CNN_CONFIG = PaperNetConfig(name="paper-cnn", kind="cnn")

LM_100M_CONFIG = ModelConfig(
    name="paper-lm-100m",
    family="dense",
    n_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, vocab_size=16384,
    rope_theta=10000.0,
    param_dtype="float32", compute_dtype="float32",
    attn_chunk=2048, remat=False,
    citation="end-to-end training model (~100M params)",
)


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen) / scale


def init_net(cfg: PaperNetConfig, seed: int = 0, device="cpu"):
    """Random parameters from ``seed`` in the JAX package's tree layout (a
    list of {"w", "b"} / {"w"} dicts); drawn on the CPU, then moved."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    if cfg.kind == "mlp":
        dims = (cfg.in_dim,) + cfg.widths + (cfg.n_classes,)
        for a, b in zip(dims[:-1], dims[1:]):
            params.append({"w": _normal(gen, (a, b), math.sqrt(a)),
                           "b": torch.zeros(b)})
    else:
        cin = 3
        for cout in cfg.channels:
            params.append({"w": _normal(gen, (3, 3, cin, cout),
                                        math.sqrt(9 * cin))})
            cin = cout
        feat = cfg.channels[-1] * (32 // (2 ** len(cfg.channels))) ** 2
        params.append({"w": _normal(gen, (feat, cfg.n_classes),
                                    math.sqrt(feat)),
                       "b": torch.zeros(cfg.n_classes)})
    return [{k: v.to(device) for k, v in p.items()} for p in params]


def mlp_net_logits(params, x):
    h = x.reshape(x.shape[0], -1)
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def cnn_net_logits(params, x):
    """x: (B, 32, 32, 3) NHWC; conv kernels HWIO.  On the card cuDNN runs
    f32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32``
    is False, which the f32 JAX reference needs."""
    h = x.permute(0, 3, 1, 2)
    for p in params[:-1]:
        h = F_.conv2d(h, p["w"].permute(3, 2, 0, 1), padding=1)
        h = F_.max_pool2d(torch.relu(h), 2)
    # flatten in the NHWC order the dense layer's rows follow
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    p = params[-1]
    return h @ p["w"] + p["b"]


def net_loss(cfg: PaperNetConfig, params, batch):
    """Cross-entropy for either net.  batch: {"x": images, "y": labels}."""
    logits = (mlp_net_logits if cfg.kind == "mlp" else cnn_net_logits)(
        params, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch["y"].long()[:, None]).mean()
