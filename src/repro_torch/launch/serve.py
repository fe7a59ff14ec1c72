"""Serving entry point of the port: batched prefill, then greedy decode
(twin of ``src/repro/launch/serve.py``, its flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --full --batch 4 --ctx 2048 --gen 16

runs qwen1.5-4b at full width on the GPU (also ``--arch rwkv6-1.6b``,
``granite-moe-1b-a400m``, ``qwen3-moe-30b-a3b``, ``zamba2-7b``, the
encoder-decoder ``seamless-m4t-large-v2`` or the vlm
``llama-3.2-vision-11b``);
``--smoke --device cpu`` runs the reduced variant on the CPU with the
kernels' plain versions.  The config is built with ``use_pallas=True``:
on the card that takes the flash-attention, RMSNorm and WKV kernels; on
the CPU it resolves to their plain versions, which compute what the JAX
package's ``use_pallas=False`` path computes (the JAX launcher never
sets the flag).  Without CUDA and without ``--device cpu`` it raises: it never
falls back.

Weights are random, from seed 0.  Smoke sizes are drawn on the CPU, so
the seed gives the same weights on every device; ``--full`` draws them
with the card's generator, since drawing 3.9 B values on the host would
take longer than serving them.  The prompt is drawn from seed 7 on the
CPU; an encoder-decoder's source, 32 frames of d_model standard normals
(the stubbed audio frontend's output, JAX's serve's 32 frames), or a
vlm's image, ``n_patches`` patch embeddings of d_model standard normals
(the stubbed vision encoder's output), from the same generator after
it.  Everything runs under
``torch.inference_mode()``.

``--mesh DxM`` (or ``PxDxM``; default ``1x1``) serves on D x M ranks,
started by ``torchrun``, whose world size must be the mesh's:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
        --smoke --mesh 2x2

Every rank draws the whole tree from seed 0 (the one-process run's
weights), keeps its slice (``sharding.shard_params``) and frees the
rest; it serves its B/D rows of the prompt, the dense and MoE families
tensor-parallel over the model axis (any family at a model axis of 1).
``--params-2d`` also cuts each big leaf over ``data``, gathered back
layer by layer as it runs.  The backend is chosen before the group
forms (``mesh.backend_for``): NCCL when each rank has a card of its
own, gloo when ranks share a card (its collectives go through the
host) and on the CPU; it is printed, never retried.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.comm import exchange
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import cut_depth
from repro_torch.models import build_model

ARCHS = ("qwen1.5-4b", "rwkv6-1.6b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b", "zamba2-7b", "seamless-m4t-large-v2",
         "llama-3.2-vision-11b")
#: encoder frames of an encoder-decoder's source (JAX's serve)
SRC_FRAMES = 32


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the reduced 2-layer variant of --arch (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the published widths and depth of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM: the data and model axes' ranks")
    ap.add_argument("--params-2d", action="store_true",
                    help="also cut each big leaf over the data axis")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def load(arch: str, smoke: bool, batch: int, ctx: int, device,
         n_layers: int | None = None):
    """(model, params, the prefill batch on ``device``) for serving: the
    batch holds the prompt ``tokens`` (batch, ctx) and, for an
    encoder-decoder, ``src_embed`` (batch, SRC_FRAMES, d_model) f32, for
    a vlm ``image_embed`` (batch, n_patches, d_model) f32.  ``n_layers``
    cuts the depth (the widths stay the config's; an encoder-decoder
    refuses it, a vlm takes whole groups only)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    model = build_model(dataclasses.replace(cfg, use_pallas=True))
    draw = "cpu" if smoke else device
    params = model.init(0, device=device, draw_device=draw)
    gen = torch.Generator().manual_seed(7)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, ctx),
                                   generator=gen)}
    if cfg.family == "encdec":
        out["src_embed"] = torch.randn((batch, SRC_FRAMES, cfg.d_model),
                                       generator=gen)
    if cfg.family == "vlm":
        out["image_embed"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                         generator=gen)
    return model, params, {k: v.to(device) for k, v in out.items()}


def shard(model, params, batch: dict, mesh, two_d: bool = False):
    """(this rank's slices of ``params``, its B/D rows of ``batch``) on
    ``mesh``; raises ``ValueError`` where the mesh cannot serve the
    config or the batch."""
    B = batch["tokens"].shape[0]
    model.cfg.check_mesh(mesh.model_size, mesh.data_size, B)
    n, i = B // mesh.data_size, mesh.dp_index
    return (sharding.shard_params(params, mesh, two_d),
            {k: v[i * n:(i + 1) * n] for k, v in batch.items()})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, batch: dict, gen: int, mesh=None) -> dict:
    """Prefill ``batch`` (the prompt ``tokens`` (B, ctx), and an
    encoder-decoder's ``src_embed`` or a vlm's ``image_embed``) into
    caches of capacity ctx + gen, then ``gen - 1`` greedy decode steps.
    Returns the tokens (batch, gen), the logits of each step (gen,
    batch, vocab) f32 (the prefill's last position first), prefill
    seconds and decode ms per step (host clock, each ending in a device
    synchronise).  Under ``mesh``: this rank's rows and slices
    (:func:`shard`), the logits gathered whole along the vocab."""
    B, ctx = batch["tokens"].shape
    dev = batch["tokens"].device
    vocab = model.cfg.vocab_size
    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, capacity=ctx + gen,
                                      mesh=mesh)
        tok = logits[:, -1:, :vocab].argmax(-1)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        toks, step_logits = [tok], [logits[:, -1, :vocab]]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, tok, cache, ctx + i,
                                              mesh=mesh)
            tok = logits[:, -1:, :vocab].argmax(-1)
            toks.append(tok)
            step_logits.append(logits[:, -1, :vocab])
        sync(dev)
        decode_s = time.perf_counter() - t0
    steps = max(gen - 1, 1)
    return dict(tokens=torch.cat(toks, dim=1).cpu(),
                logits=torch.stack(step_logits).float().cpu(),
                prefill_s=prefill_s, decode_ms_per_step=decode_s / steps * 1e3,
                decode_tokens_per_s=B * steps / decode_s if decode_s else 0.0)


def main(argv=None) -> dict:
    """Run the CLI; returns the result dict of :func:`generate` (this
    rank's rows) with the arch, shapes, device, mesh, this rank's
    resident weight bytes and peak device memory (bytes, since before
    the load and since the weights were sliced; 0 on the CPU)."""
    args = parse_args(argv)
    shape, axes = mesh_mod.parse_mesh(args.mesh)
    world = math.prod(shape)
    dev = mesh_mod.resolve_device(args.device)
    created, backend = False, None
    if world > 1 or "WORLD_SIZE" in os.environ:
        backend = mesh_mod.backend_for(dev, world)
        if int(os.environ.get("RANK", 0)) == 0:
            print(f"mesh {args.mesh} {axes}: {world} ranks on {dev.type}, "
                  f"backend {backend}", flush=True)
        created = exchange.init_process_group(dev, backend)
    try:
        mesh = mesh_mod.make_mesh(shape, axes)
        return _serve(args, dev, mesh, backend)
    finally:
        if created:
            dist.destroy_process_group()


def _serve(args, dev, mesh, backend) -> dict:
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, batch = load(args.arch, args.smoke, args.batch,
                                args.ctx, dev)
    params, batch = shard(model, params, batch, mesh, args.params_2d)
    weight_bytes = sharding.tensor_bytes(params)
    load_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res = generate(model, params, batch, args.gen, mesh)
    del params
    serve_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res.update(arch=args.arch, smoke=args.smoke, batch=args.batch,
               ctx=args.ctx, gen=args.gen, device=str(dev), mesh=args.mesh,
               params_2d=args.params_2d, backend=backend, rank=mesh.rank,
               weight_bytes=weight_bytes, serve_peak_bytes=serve_peak,
               peak_memory_bytes=max(load_peak, serve_peak))
    if mesh.rank == 0:
        print(f"[{args.arch}{' smoke' if args.smoke else ''}] prefill "
              f"{args.batch}x{args.ctx} on mesh {args.mesh} ({dev}): "
              f"{res['prefill_s']:.4f} s; decode "
              f"{res['decode_ms_per_step']:.3f} ms/step "
              f"({res['decode_tokens_per_s']:.1f} tokens/s); peak memory "
              f"{res['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        for i in range(min(len(res["tokens"]), 4)):
            print(f"  req{i}: {res['tokens'][i].tolist()[:16]}")
    if math.prod(mesh.shape) > 1:
        print(f"rank {mesh.rank} {dict(zip(mesh.axis_names, mesh.coords))}"
              f": weights {weight_bytes} B, peak after the slice "
              f"{serve_peak / 2**30:.3f} GiB", flush=True)
    return res


if __name__ == "__main__":
    main()
