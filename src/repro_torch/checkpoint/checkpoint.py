"""Tree checkpointing: npz-based, step-managed, restart-safe (twin of
``src/repro/checkpoint/checkpoint.py``).

Layout, file for file the JAX package's::

    <dir>/step_<N:010d>/
        manifest.json      (leaf paths + leaf dtypes/shapes + metadata)
        arrays.npz         (flattened leaves, keyed leaf_<i>)
        COMMITTED          (written last -> partial checkpoints are ignored)

Crash-safety (DESIGN.md §16): every file lands via tmp-file +
``os.replace`` and the whole step directory is assembled under a ``.tmp``
suffix, renamed into place only after the COMMITTED marker exists — a
kill at ANY point leaves either the previous committed checkpoint or a
``.tmp`` directory that discovery ignores.  ``restore`` falls back to the
next older committed step (with a logged warning) when the newest one
turns out to be corrupt on disk.

A tree is nested dicts (keys sorted), lists, tuples and dataclasses
(fields in order) over these leaves, each restored as the type of the
skeleton's leaf at its path:

* tensors, saved through ``.cpu()`` and restored onto the skeleton
  leaf's device; bf16 is stored as its uint16 bit patterns (numpy has no
  bf16) under the manifest dtype ``bfloat16``;
* host scalars (``np.float32``, Python ``int``), bits unchanged;
* ``None`` (the EF memory of the kinds that do not compress), which
  stores no array.

Where the JAX package writes its tree structure, the manifest holds the
leaf paths (``params/blocks/mlp/wg``, ``state/alpha_prev``); a restore
checks the count, the paths, the dtypes and the shapes against the
skeleton and raises ``AssertionError`` on a mismatch, never taken for
corruption.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import zipfile
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)

# exactly the errors a torn/corrupt on-disk checkpoint produces: missing
# files, truncated npz (zipfile/EOF), garbage json, missing leaf keys.
# AssertionError is deliberately NOT here — a skeleton/shape mismatch is
# a caller bug, not disk corruption, and must propagate.
CORRUPTION_ERRORS = (OSError, ValueError, zipfile.BadZipFile, KeyError,
                     EOFError)

_NONE = "none"


def _flatten(tree, path: str, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}/{i}" if path else str(i), out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name),
                     f"{path}/{f.name}" if path else f.name, out)
    else:
        out.append((path, tree))


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in
    ``_flatten``'s order."""
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)([_rebuild(v, it) for v in tree])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it)


def _dtype_name(leaf) -> str:
    if leaf is None:
        return _NONE
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _shape(leaf):
    return None if leaf is None else list(np.shape(leaf))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(like.device)
    if isinstance(like, (int, float)):
        return type(like)(arr[()])
    return arr.dtype.type(arr[()])


def _write_atomic(path: str, writer) -> None:
    """Write via ``writer(tmp_path)`` then ``os.replace`` into place, so
    a crash mid-write never leaves a half-written file at ``path``."""
    tmp = path + ".tmp"
    writer(tmp)
    os.replace(tmp, path)


def save(directory: str, step: int, tree: Any,
         metadata: dict | None = None, keep: int = 3) -> str:
    """Atomically save ``tree`` at ``step``; prunes to ``keep`` newest.

    The previous committed checkpoint stays intact (and discoverable)
    until this one's COMMITTED marker is in place."""
    path = os.path.join(directory, f"step_{step:010d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves: list = []
    _flatten(tree, "", leaves)
    arrays = {f"leaf_{i}": _to_numpy(leaf)
              for i, (_, leaf) in enumerate(leaves) if leaf is not None}

    def write_arrays(p):
        # np.savez appends ".npz" to bare paths — hand it a file object
        # so the tmp-file name survives for os.replace
        with open(p, "wb") as f:
            np.savez(f, **arrays)

    _write_atomic(os.path.join(tmp, "arrays.npz"), write_arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "paths": [p for p, _ in leaves],
        "dtypes": [_dtype_name(leaf) for _, leaf in leaves],
        "shapes": [_shape(leaf) for _, leaf in leaves],
        "metadata": metadata or {},
    }

    def write_manifest(p):
        with open(p, "w") as f:
            json.dump(manifest, f, indent=1)

    _write_atomic(os.path.join(tmp, "manifest.json"), write_manifest)

    def write_marker(p):
        with open(p, "w") as f:
            f.write("ok")

    _write_atomic(os.path.join(tmp, "COMMITTED"), write_marker)
    if os.path.exists(path):
        # re-saving the SAME step: the old dir must move out of the way
        # (dir-over-dir rename is not atomic); park it under .old first
        # so a crash between the two renames still leaves a committed
        # copy discoverable by the fallback scan below
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)
    _prune(directory, keep)
    return path


def _prune(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                not name.endswith(".old") and \
                os.path.exists(os.path.join(directory, name, "COMMITTED")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load_step(directory: str, step: int, tree_like: Any):
    """Load one committed step; raises CORRUPTION_ERRORS on torn files
    and AssertionError on a skeleton mismatch (which must propagate)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    like: list = []
    _flatten(tree_like, "", like)
    assert manifest["n_leaves"] == len(like), \
        (manifest["n_leaves"], len(like))
    assert manifest["paths"] == [p for p, _ in like], \
        (manifest["paths"], [p for p, _ in like])
    leaves = []
    for i, (p, leaf) in enumerate(like):
        assert manifest["dtypes"][i] == _dtype_name(leaf), \
            (p, manifest["dtypes"][i], _dtype_name(leaf))
        if leaf is None:
            leaves.append(None)
            continue
        arr = data[f"leaf_{i}"]
        assert list(arr.shape) == _shape(leaf), (p, arr.shape, _shape(leaf))
        leaves.append(_from_numpy(arr, leaf))
    return _rebuild(tree_like, iter(leaves)), manifest["metadata"]


def restore(directory: str, tree_like: Any,
            step: int | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (paths, dtypes and
    shapes are verified).

    With ``step=None`` (resume-from-latest), a checkpoint whose files
    turn out corrupt on disk is skipped with a logged warning and the
    next older committed step is tried — a torn write must not strand an
    otherwise-resumable run.  An explicitly requested ``step`` raises
    instead of silently answering with different data.
    """
    if step is not None:
        return _load_step(directory, step, tree_like)
    candidates = sorted(all_steps(directory), reverse=True)
    if not candidates:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    last_err = None
    for s in candidates:
        try:
            return _load_step(directory, s, tree_like)
        except AssertionError:
            raise                      # caller bug, not disk corruption
        except CORRUPTION_ERRORS as e:
            logger.warning(
                "checkpoint step_%010d in %s is corrupt (%s: %s) — "
                "falling back to the next older committed step",
                s, directory, type(e).__name__, e)
            last_err = e
    raise FileNotFoundError(
        f"every committed checkpoint in {directory} is corrupt "
        f"(last error: {type(last_err).__name__}: {last_err})")
