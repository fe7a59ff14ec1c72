"""Partition rules (twin of ``src/repro/sharding.py``): which dim of each
parameter the mesh's axes cut, and this rank's slice of a tree.

The rules are JAX's, by leaf name, with negative dims, so they apply
alike to unstacked, (L, ...)- and (G, per, ...)-stacked leaves.  The
model axis cuts the attention heads (q/k/v out-dim, o in-dim), the MLP
hidden dim, the MoE experts, the SSM inner channels, the embedding's
d_model and the head's vocab.  A spec is a tuple of axis names or None,
one entry a dim, which compares with JAX's ``PartitionSpec`` entry for
entry.

:func:`shard_params` keeps this rank's slice of every leaf.  Under
``two_d`` (serving's ``--params-2d``) a widened leaf is also cut over
``data``; it comes back as a :class:`DataShard`, which
:func:`gather_data` takes back to whole over the data axis just before
its layer runs (JAX's "XLA inserts it inside the layer scan").

:func:`tp_sum` and :func:`tp_gather` are the model axis's collectives in
the layers (JAX's ``hint(..., TP)`` cuts): identity without a mesh or at
a model axis of 1.  JAX's ``param_shardings`` (training placement) and
``cache_pspecs`` (the dry-run's sequence-sharded decode) have no caller
in the port yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import exchange
from repro_torch.utils import tree_leaves, tree_map, tree_map_with_path

# (leaf-name match) -> dim (negative index) to shard over 'model'
_COL_NAMES = {"wq", "wk", "wv", "wg", "wi", "cm_k", "in_proj"}   # last dim
_ROW_NAMES = {"wo", "out_proj", "cm_v"}                          # dim -2
_VEC_LAST = {"conv_w", "conv_b", "A_log", "D_skip", "dt_bias", "u",
             "w_base", "ln_w", "ln_b"}
#: JAX's ``widen``: leaves of this many elements or more take a data axis
WIDEN_MIN = 2 ** 20


def _path_names(path) -> list[str]:
    return [str(p) for p in path]


def leaf_pspec(path, leaf) -> tuple:
    """The spec of one leaf at ``path`` (its keys): JAX's rules."""
    names = _path_names(path)
    ndim = leaf.ndim
    spec = [None] * ndim

    def set_dim(neg_idx):
        if ndim + neg_idx >= 0:
            spec[neg_idx] = "model"

    if "moe" in names:
        # router replicated; expert tensors sharded on E (dim -3)
        if names[-1] in ("wg", "wi", "wo"):
            set_dim(-3)
        return tuple(spec)
    if "embed" in names:
        set_dim(-1)          # (V, D): shard d_model -> local token gather
        return tuple(spec)
    if "lm_head" in names:
        set_dim(-1)          # (D, V): vocab-parallel logits
        return tuple(spec)
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if last == "w" and parent in _COL_NAMES:
        set_dim(-1)
    elif last == "w" and parent in _ROW_NAMES:
        set_dim(-2)
    elif last == "b" and parent in _COL_NAMES:
        set_dim(-1)
    elif last in _COL_NAMES and ndim >= 2:      # rwkv raw arrays
        set_dim(-1)
    elif last in _ROW_NAMES and ndim >= 2:
        set_dim(-2)
    elif last in _VEC_LAST:
        if last == "u":
            set_dim(-2)
        elif last not in ("w_base", "ln_w", "ln_b"):
            set_dim(-1)      # the small per-channel vectors replicate
    elif parent == "norm" and last == "w":
        # mamba gated-norm over sharded d_in
        set_dim(-1)
    return tuple(spec)


def _widen(leaf, spec: tuple, dp_axis: str) -> tuple:
    """JAX's ``widen``: a leaf of 2 or more dims and WIDEN_MIN or more
    elements takes ``dp_axis`` on its largest unsharded dim divisible by
    16 (the last such on a tie)."""
    if leaf.ndim < 2 or leaf.numel() < WIDEN_MIN:
        return spec
    cand = [(leaf.shape[i], i) for i in range(leaf.ndim)
            if spec[i] is None and leaf.shape[i] % 16 == 0]
    if not cand:
        return spec
    _, dim = max(cand)
    return spec[:dim] + (dp_axis,) + spec[dim + 1:]


def param_pspecs(params, two_d: bool = False, dp_axis: str = "data"):
    """The tree of specs: the model axis alone (replicated over the data
    axes, as the per-worker gradients of DCSGD-ASSS need), or under
    ``two_d`` (serving only) each big leaf's largest unsharded dim also
    over ``dp_axis``."""
    specs = tree_map_with_path(leaf_pspec, params)
    if not two_d:
        return specs
    return tree_map(lambda leaf, s: _widen(leaf, s, dp_axis), params, specs)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's slice of a leaf cut over a data axis (``two_d``):
    ``local`` along ``dim`` (negative) over ``axis``.  Indexing takes a
    layer of a stacked leaf, as ``lm._layer`` does for a tensor."""
    local: torch.Tensor
    dim: int
    axis: str

    def __getitem__(self, i) -> "DataShard":
        out = DataShard(self.local[i], self.dim, self.axis)
        if out.local.ndim + self.dim < 0:
            raise ValueError(f"a layer index {i} takes the data-sharded "
                             f"dim {self.dim} of a {tuple(self.local.shape)}"
                             " leaf: gather it before indexing")
        return out


def _slice(leaf: torch.Tensor, spec: tuple, mesh):
    """This rank's block of ``leaf`` by ``spec``: a copy, so that the
    whole leaf can be freed; the leaf itself where nothing is cut."""
    out, data_dim = leaf, None
    for i, axis in enumerate(spec):
        n = mesh.size(axis) if axis is not None else 1
        if n == 1:
            continue
        if leaf.shape[i] % n:
            raise ValueError(f"a {tuple(leaf.shape)} leaf cannot be cut in "
                             f"{n} along dim {i} over {axis!r} (spec {spec})")
        size = leaf.shape[i] // n
        out = out.narrow(i, mesh.coord(axis) * size, size)
        if axis != "model":
            data_dim = (i - leaf.ndim, axis)
    if out is leaf:
        return leaf
    out = out.clone()
    return out if data_dim is None else DataShard(out, *data_dim)


def shard_params(params, mesh, two_d: bool = False):
    """This rank's slice of every leaf of ``params`` (the whole tree on
    each rank) by :func:`param_pspecs`: over ``model`` by the model
    coordinate and, under ``two_d``, over ``data`` by the data
    coordinate (such a leaf comes back as a :class:`DataShard`).
    Raises ``ValueError`` where a cut dim does not divide."""
    specs = param_pspecs(params, two_d=two_d)
    return tree_map(lambda leaf, s: _slice(leaf, s, mesh), params, specs)


def gather_data(tree, mesh):
    """``tree`` with every :class:`DataShard` gathered whole over its
    axis (the other leaves as they are)."""
    if mesh is None:
        return tree
    return tree_map(
        lambda x: exchange.all_gather_dim(x.local, x.dim, mesh.groups[x.axis])
        if isinstance(x, DataShard) else x, tree)


def tensor_bytes(tree) -> int:
    """Bytes of a tree's tensors (of a DataShard, its local slice)."""
    return sum((x.local if isinstance(x, DataShard) else x).nbytes
               for x in tree_leaves(tree))


def tp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's partial sums added over the model axis."""
    if mesh is None or mesh.model_size == 1:
        return x
    return exchange.all_reduce_sum(x, mesh.groups["model"])


def tp_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """A model-sharded activation gathered whole along ``dim``."""
    if mesh is None or mesh.model_size == 1:
        return x
    return exchange.all_gather_dim(x, dim, mesh.groups["model"])
