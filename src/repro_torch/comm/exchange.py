"""Packed payload exchange over the data-parallel process group (twin of
``src/repro/comm/exchange.py``), and the model axis's two collectives,
:func:`all_reduce_sum` and :func:`all_gather_dim`.

The compressed path's only collective is an ``all_gather`` of packed
words: ONE flat buffer on the ``bucketed`` transport, one per leaf on
``perleaf``; :func:`check_bucket_payload` / :func:`check_payload`
guarantee before it that the buffer is exactly the bytes
``Compressor.wire_bytes`` accounts for.  The
words move as int32: NCCL and gloo support uint32 collectives thinly,
and the bits are the same.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def check_payload(payload: torch.Tensor, spec, comp, d: int) -> None:
    """The (L, row_words) payload of one leaf about to cross the process
    group (the ``perleaf`` transport) is exactly the bytes
    ``Compressor.wire_bytes`` accounts for.  Raises (not assert)."""
    if payload.dtype != torch.int32:
        raise ValueError(f"payload must be int32 words, got {payload.dtype}")
    if payload.shape[-1] != spec.row_words:
        raise ValueError(f"payload row is {payload.shape[-1]} words, "
                         f"spec says {spec.row_words}")
    accounted = comp.wire_bytes(d)
    if spec.row_bytes != accounted:
        raise ValueError(
            f"wire accounting drift: payload row is {spec.row_bytes} B but "
            f"Compressor.wire_bytes({d}) = {accounted} B")


def check_bucket_payload(payload: torch.Tensor, plan, comp) -> None:
    """The flat buffer about to cross the process group is exactly the
    per-leaf accounted bytes, with every lane at its planned offset.
    Raises (not assert), so the contract holds under ``python -O``."""
    if payload.dtype != torch.int32:
        raise ValueError(f"payload must be int32 words, got {payload.dtype}")
    if tuple(payload.shape) != (plan.total_words,):
        raise ValueError(f"bucket payload is {tuple(payload.shape)}, plan "
                         f"says ({plan.total_words},)")
    words = 0
    for lane in plan.leaves:
        if lane.dense:
            continue
        accounted = comp.wire_bytes(lane.d)
        if lane.spec.row_bytes != accounted:
            raise ValueError(
                f"wire accounting drift: leaf {lane.index} payload row is "
                f"{lane.spec.row_bytes} B but Compressor.wire_bytes"
                f"({lane.d}) = {accounted} B")
        if lane.word_off != words:
            raise ValueError(f"bucket offset drift: leaf {lane.index} at "
                             f"word {lane.word_off}, expected {words}")
        words += lane.words
    if words != plan.total_words:
        raise ValueError(f"bucket plan sums to {words} words, total_words "
                         f"says {plan.total_words}")


def gather_packed(payload: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather one worker's int32 payload, flat (n,) or (L, words) ->
    (W, *payload.shape), rows in rank order."""
    W = dist.get_world_size(group)
    out = torch.empty((W * payload.numel(),), dtype=payload.dtype,
                      device=payload.device)
    dist.all_gather_into_tensor(out, payload.contiguous().reshape(-1),
                                group=group)
    return out.reshape(W, *payload.shape)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the process group (the JAX ``psum`` of a row-parallel
    product): the ranks' tensors added in f32 (or wider), the sum rounded
    once to x's dtype.  gloo moves a CUDA tensor through the host."""
    y = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated along ``dim`` in rank
    order (the gather a sharded leaf or activation takes back to
    whole).  The list form of ``all_gather``, which gloo takes for CUDA
    tensors too."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the process group (the JAX ``pmean``)."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


#: tries at a group of one, each on a fresh port
PORT_ATTEMPTS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device: torch.device,
                       backend: str | None = None) -> bool:
    """Join the data-parallel process group: NCCL on cuda, gloo on cpu,
    or ``backend`` where given (``"cpu:gloo,cuda:nccl"`` for one group
    that serves a CPU run and a card run).  Under ``torchrun`` the rank
    and world size come from its environment; otherwise a group of one
    on a free localhost port, so the collectives run on one device too
    (another process can take the port between ``_free_port`` and the
    bind: then a fresh port, up to ``PORT_ATTEMPTS`` in all).  Returns
    True when this call created the group (the caller destroys it)."""
    if dist.is_initialized():
        return False
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True
    for attempt in range(PORT_ATTEMPTS):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
            return True
        except dist.DistNetworkError:
            if attempt == PORT_ATTEMPTS - 1:
                raise
