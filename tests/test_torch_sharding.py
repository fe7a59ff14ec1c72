"""The port's partition rules (``repro_torch/sharding.py``) and meshes
(``repro_torch/launch/mesh.py``) against the JAX package's
``src/repro/sharding.py``, on the CPU.

Every arch config at full size: the port's tree in fake tensors beside
JAX's ``eval_shape`` tree, leaf for leaf (path, shape) and spec for spec
(JAX's ``PartitionSpec`` entries), with ``two_d`` off and on.  Then
``shard_params`` on smoke trees against numpy slices by JAX's specs at
every rank of a 2x2 mesh, ``dp_axes_of``, and the mesh's row-major
coordinates and groups.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import sharding as jsharding
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch import sharding
from repro_torch.configs import ARCH_CONFIGS, get_config
from repro_torch.convert import to_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.utils import tree_flatten, tree_map_with_path

ARCHS = sorted(ARCH_CONFIGS)


def _jax_flat(tree, two_d):
    """JAX's (path names, shape, spec entries) for every leaf of
    ``tree``, in flatten order."""
    specs = jax.tree.leaves(jsharding.param_pspecs(tree, two_d=two_d),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(jsharding._path_names(p)), tuple(x.shape), tuple(s))
            for (p, x), s in zip(leaves, specs)]


def _port_flat(tree, two_d):
    paths = tree_flatten(tree_map_with_path(lambda p, _: p, tree))[0]
    leaves = tree_flatten(tree)[0]
    specs = tree_flatten(sharding.param_pspecs(tree, two_d=two_d))[0]
    return [(tuple(str(k) for k in p), tuple(x.shape), s)
            for p, x, s in zip(paths, leaves, specs)]


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_on_every_arch(arch, two_d):
    want = _jax_flat(jax.eval_shape(jax_build_model(jax_config(arch)).init,
                                    jax.random.PRNGKey(0)), two_d)
    with FakeTensorMode():
        got = _port_flat(build_model(get_config(arch)).init(0), two_d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    assert any("model" in s for _, _, s in got)
    # every full-size tree has leaves past 2^20 elements: two_d widens
    assert any("data" in s for _, _, s in got) == two_d


def test_leaf_pspec_rules_by_name():
    """Each branch of the rules on small leaves: port == JAX."""
    cases = [(("blocks", "moe", "wg"), (2, 4, 8, 6)),
             (("blocks", "moe", "router", "w"), (2, 8, 4)),
             (("embed", "w"), (16, 8)), (("lm_head", "w"), (8, 16)),
             (("blocks", "attn", "wq", "w"), (2, 8, 8)),
             (("blocks", "attn", "wo", "w"), (2, 8, 8)),
             (("blocks", "attn", "wq", "b"), (2, 8)),
             (("blocks", "rwkv", "cm_k"), (2, 8, 16)),
             (("blocks", "rwkv", "cm_v"), (2, 16, 8)),
             (("blocks", "rwkv", "u"), (2, 4, 8)),
             (("blocks", "rwkv", "w_base"), (2, 8)),
             (("blocks", "mamba", "conv_w"), (2, 4, 8)),
             (("blocks", "mamba", "norm", "w"), (2, 8)),
             (("blocks", "attn_norm", "w"), (2, 8)), (("x",), (8,))]
    for names, shape in cases:
        leaf = torch.zeros(shape)
        path = [jax.tree_util.DictKey(n) for n in names]
        want = tuple(jsharding.leaf_pspec(path, np.zeros(shape)))
        assert sharding.leaf_pspec(names, leaf) == want, names


def _np_slice(x, spec, coords):
    for i, axis in enumerate(spec):
        if axis is not None:
            n = 2                         # every axis of the 2x2 mesh
            size = x.shape[i] // n
            x = np.take(x, range(coords[axis] * size,
                                 (coords[axis] + 1) * size), axis=i)
    return x


@pytest.mark.parametrize("arch, kw", [
    ("qwen1.5-4b", dict(n_kv_heads=2, vocab_size=8192, d_ff=4096)),
    ("granite-moe-1b-a400m", {}), ("rwkv6-1.6b", {}), ("zamba2-7b", {})],
    ids=["qwen-wide", "granite", "rwkv", "zamba2"])
@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_shard_params_equals_numpy_slices_of_jax_specs(arch, kw, two_d):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    specs = jax.tree.leaves(jsharding.param_pspecs(tree, two_d=two_d),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    leaves = jax.tree.leaves(tree)
    widened = 0
    for rank in range(4):
        mesh = mesh_mod.Mesh((2, 2), mesh_mod.AXES_2D, rank)
        coords = dict(zip(mesh.axis_names, mesh.coords))
        local = tree_flatten(sharding.shard_params(to_torch(tree), mesh,
                                                   two_d))[0]
        assert len(local) == len(leaves)
        for x, spec, got in zip(leaves, specs, local):
            if "data" in tuple(spec):
                assert isinstance(got, sharding.DataShard)
                assert got.dim == tuple(spec).index("data") - x.ndim
                got, widened = got.local, widened + 1
            np.testing.assert_array_equal(
                got.numpy(), _np_slice(x, tuple(spec), coords))
    assert (widened > 0) == (two_d and arch == "qwen1.5-4b")


def test_dp_axes_and_row_major_mesh():
    two = mesh_mod.Mesh((2, 4), mesh_mod.AXES_2D, 5)
    three = mesh_mod.Mesh((2, 2, 2), mesh_mod.AXES_3D, 6)
    assert sharding.dp_axes_of(two) == ("data",)
    assert sharding.dp_axes_of(three) == ("pod", "data")
    # rank r at numpy.unravel_index(r, shape), as jax.make_mesh lays out
    assert two.coords == (1, 1) and (two.data_size, two.model_size) == (2, 4)
    assert three.coords == (1, 1, 0) and three.dp_index == 3
    assert three.data_size == 4 and three.model_size == 2
    for shape in ((2, 4), (2, 2, 2), (16, 16)):
        for r in range(int(np.prod(shape))):
            assert mesh_mod.mesh_coords(shape, r) == np.unravel_index(
                r, shape)
    groups = mesh_mod._groups_along
    assert groups((2, 4), [1]) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert groups((2, 4), [0]) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    # the data-parallel group: every axis but model, in dp_index order
    assert groups((2, 2, 2), [0, 1]) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [mesh_mod.Mesh((2, 2, 2), mesh_mod.AXES_3D, r).dp_index
            for r in (1, 3, 5, 7)] == [0, 1, 2, 3]
