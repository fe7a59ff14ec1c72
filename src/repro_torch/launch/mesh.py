"""Device meshes of the port (twin of ``src/repro/launch/mesh.py``) and
the H100's data-sheet rates.

A :class:`Mesh` lays the ranks of the default process group out over
named axes row-major, as ``jax.make_mesh`` lays devices out: rank r sits
at ``numpy.unravel_index(r, shape)``.  It holds one process group per
axis of size above 1 (the ranks that differ only along that axis) and
the data-parallel group (every axis but ``model``, JAX's ``dp_axes_of``).
A mesh of one rank needs no process group at all.

The mesh reaches the model as an explicit argument, not as ambient
state: ``Model.prefill(params, batch, capacity=..., mesh=mesh)``,
``Model.decode_step(params, token, cache, n, mesh=mesh)`` and
``Model.init_cache(..., mesh=mesh)``.  ``mesh=None`` is the one-process
path, and a 1x1 mesh computes exactly what it computes.

Ranks that share one card cannot form an NCCL communicator (NCCL refuses
a second rank on the same GPU), so :func:`backend_for` picks NCCL only
when every rank of the host has a card of its own, gloo otherwise (gloo
moves CUDA tensors through the host), and gloo on the CPU.  The choice
is made before the group forms and never retried on another backend.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import dp_axes_of

#: NVIDIA H100 SXM5 data sheet (dense rates, no sparsity, at 700 W)
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores, per card
PEAK_FLOPS_F32 = 67e12          # f32 outside the tensor cores, per card
HBM_BW = 3.35e12                # bytes/s of HBM3, per card
NVLINK_BW = 900e9               # bytes/s of NVLink 4, per card, both ways

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DxM"`` -> ((D, M), ("data", "model")); ``"PxDxM"`` -> ((P, D, M),
    ("pod", "data", "model")), the axes of JAX's launchers."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"mesh {spec!r}: want DxM or PxDxM, positive ints")
    return dims, AXES_2D if len(dims) == 2 else AXES_3D


def mesh_coords(shape, rank: int) -> tuple[int, ...]:
    """The row-major coordinates of ``rank`` in a mesh of ``shape``."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(shape)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh of named axes and the process groups
    along them (None for an axis of size 1)."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    dp_group: Any = dataclasses.field(default=None, repr=False)

    @property
    def coords(self) -> tuple[int, ...]:
        return mesh_coords(self.shape, self.rank)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 1

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] \
            if axis in self.axis_names else 0

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return dp_axes_of(self)

    @property
    def model_size(self) -> int:
        return self.size("model")

    @property
    def data_size(self) -> int:
        """Ranks along the data-parallel axes together: the batch splits
        over them."""
        return math.prod(self.size(a) for a in self.dp_axes)

    @property
    def dp_index(self) -> int:
        """This rank's row-major index over the data-parallel axes: its
        share of the batch, and its rank in ``dp_group``."""
        return int(np.ravel_multi_index(
            [self.coord(a) for a in self.dp_axes],
            [self.size(a) for a in self.dp_axes])) if self.dp_axes else 0


def _groups_along(shape, axes: list[int]) -> list[list[int]]:
    """Every set of ranks that agree on all axes but ``axes``, each
    sorted, in row-major order of the other coordinates."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    keep = [i for i in range(len(shape)) if i not in axes]
    moved = np.moveaxis(ranks, keep + axes, list(range(len(shape))))
    n = math.prod(shape[i] for i in axes)
    return [sorted(int(r) for r in row) for row in moved.reshape(-1, n)]


def make_mesh(shape, axes) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the default process group,
    whose size must be the mesh's; a mesh of one rank needs no group.
    Every rank calls it (``dist.new_group`` is collective)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ")
    n = math.prod(shape)
    if n == 1 and not dist.is_initialized():
        return Mesh(shape, axes, 0)
    if not dist.is_initialized() or dist.get_world_size() != n:
        got = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(f"mesh {'x'.join(map(str, shape))} takes {n} ranks"
                         f", the process group has {got}")
    rank = dist.get_rank()

    def group_of(dims):
        mine = None
        for ranks in _groups_along(shape, dims):
            g = dist.new_group(ranks)        # collective: every rank calls
            if rank in ranks:
                mine = g
        return mine

    groups = {a: group_of([i]) if shape[i] > 1 else None
              for i, a in enumerate(axes)}
    dp = [i for i, a in enumerate(axes) if a != "model"]
    dp_group = group_of(dp) if math.prod(shape[i] for i in dp) > 1 \
        else None
    return Mesh(shape, axes, rank, groups, dp_group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shapes: (data 16, model 16), or (pod 2, data 16,
    model 16) across two pods."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16),
                     AXES_3D if multi_pod else AXES_2D)


def make_test_mesh(shape=(4, 2), axes=AXES_2D) -> Mesh:
    """JAX's small test mesh."""
    return make_mesh(shape, axes)


def backend_for(device: torch.device, world_size: int) -> str:
    """The process group's backend for ``world_size`` ranks on
    ``device``: gloo on the CPU; on CUDA, NCCL when every rank of this
    host has a card of its own, else gloo (ranks sharing a card; NCCL
    would refuse the duplicate GPU)."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def resolve_device(name: str) -> torch.device:
    """``cpu``, or ``cuda``: this process's card, ``LOCAL_RANK`` (under
    torchrun) modulo the cards of the host, so ranks share cards when
    there are fewer cards than ranks.  Raises without CUDA: no fallback
    from one to the other."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r} (want cuda | cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch path on the CPU")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
