"""Parameter trees of nested dicts and lists (the port's stand-in for
``jax.tree``).

Leaves are ordered like ``jax.tree.flatten`` orders them: dict keys
sorted, list items in order, depth first.  The wire payload's leaf
offsets follow this order, so it is part of the bit-exact contract with
the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_flatten(tree) -> tuple[list, Any]:
    """(leaves, structure) of a nested dict/list; other values are
    leaves."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def _flatten_into(t, leaves: list):
    # module-level recursion: a nested function that calls itself sits in
    # a reference cycle, which would keep every leaf (device memory
    # included) alive until Python's cycle collector happens to run
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, list):
        return [_flatten_into(v, leaves) for v in t]
    leaves.append(t)
    return None


def tree_unflatten(structure, leaves) -> Any:
    return _unflatten_from(structure, iter(leaves))


def _unflatten_from(s, it):
    if isinstance(s, dict):
        return {k: _unflatten_from(v, it) for k, v in s.items()}
    if isinstance(s, list):
        return [_unflatten_from(v, it) for v in s]
    return next(it)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(structure,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict/list; path is the tuple of
    keys and list positions."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def value_and_grad(loss_fn: Callable, params):
    """(loss, grads) of ``loss_fn(params) -> scalar tensor``; grads is a
    tree shaped like params.  The loss comes back detached."""
    leaves, structure = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(structure, req))
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(structure, list(grads))
