"""Worker bodies of the model-axis tests (tests/test_torch_tp_serve.py,
tests/test_torch_moe_ep.py): a helper, not collected.

Each body runs on every rank of a gloo group that
``torch_overlap_workers.Spawned`` starts, builds the mesh of ``shape``
over ``("data", "model")`` (the world is the mesh) and returns numpy
results for the parent to hold against JAX.  This module imports no JAX,
so a spawned worker pays for torch alone.
"""
import numpy as np
import torch

from repro_torch import sharding
from repro_torch.convert import to_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.models import build_model, moe
from repro_torch.utils import tree_leaves


def _kv(cache):
    """The self-attention cache's (k, v), or None (RWKV has none)."""
    if cache.kv == ():
        return None
    return cache.kv.k.clone().numpy(), cache.kv.v.clone().numpy()


def serve_cases(rank, W, shape, cases):
    """For each case ``(name, cfg, params (numpy), batch (numpy: the
    prompt ``tokens`` (B, ctx) and any ``src_embed`` / ``image_embed``),
    cap, decode steps)`` and ``two_d`` off and on: this rank's prefill
    and greedy decode steps through ``serve.shard`` on the mesh.  Returns
    ``{(name, two_d): dict(logits=[(B/D, vocab) a step], tokens=[(B/D,
    1) a step], caches=[(k, v) or None after prefill, after the last
    step], widened=leaves cut over data)}``."""
    mesh = mesh_mod.make_mesh(shape, mesh_mod.AXES_2D)
    out = {}
    for name, cfg, params, whole, cap, steps in cases:
        model = build_model(cfg)
        ctx = whole["tokens"].shape[1]
        for two_d in (False, True):
            local, batch = serve.shard(
                model, to_torch(params),
                {k: torch.from_numpy(v) for k, v in whole.items()},
                mesh, two_d)
            res = dict(logits=[], tokens=[], caches=[], widened=sum(
                isinstance(x, sharding.DataShard)
                for x in tree_leaves(local)))
            with torch.inference_mode():
                logits, cache = model.prefill(local, batch, capacity=cap,
                                              mesh=mesh)
                res["caches"].append(_kv(cache))
                for i in range(steps):
                    tok = logits[:, -1:].argmax(-1)
                    res["logits"].append(logits[:, -1].numpy().copy())
                    res["tokens"].append(tok.numpy())
                    logits, cache = model.decode_step(local, tok, cache,
                                                      ctx + i, mesh=mesh)
                res["logits"].append(logits[:, -1].numpy().copy())
                res["caches"].append(_kv(cache))
            out[(name, two_d)] = res
    return out


def moe_capacity(rank, W, shape, cases, params, x):
    """``moe.moe_block`` on this rank's rows of ``x`` (B, S, D) and its
    experts of ``params`` (numpy, JAX's ``init_moe`` tree), for each
    ``(name, cfg, no_drop)`` of ``cases``.  Returns ``{name: this rank's
    y}`` and the rank's (dp index, model coordinate)."""
    mesh = mesh_mod.make_mesh(shape, mesh_mod.AXES_2D)
    p = sharding.shard_params({"moe": to_torch(params)}, mesh)["moe"]
    n = x.shape[0] // mesh.data_size
    xl = torch.from_numpy(x[mesh.dp_index * n:(mesh.dp_index + 1) * n])
    out = {}
    for name, cfg, no_drop in cases:
        y, _ = moe.moe_block(p, xl, cfg, no_drop=no_drop, mesh=mesh)
        out[name] = y.numpy()
    return out, (mesh.dp_index, mesh.coord("model"))


def serve_smoke_on_card(rank, W, shape, arch, ctx, gen):
    """``serve.generate`` of ``arch``'s smoke on the card under the mesh
    (the ranks share card 0, their gloo group moving CUDA tensors through
    the host): this rank's (tokens, logits) as numpy."""
    mesh = mesh_mod.make_mesh(shape, mesh_mod.AXES_2D)
    dev = torch.device("cuda", 0)
    model, params, batch = serve.load(arch, True, 2, ctx, dev)
    params, batch = serve.shard(model, params, batch, mesh)
    res = serve.generate(model, params, batch, gen, mesh)
    return res["tokens"].numpy(), res["logits"].numpy()
