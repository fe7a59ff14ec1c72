"""The port's checkpoints against the JAX package's, and the trainer's
``--ckpt-dir`` / ``--ckpt-every`` / ``--resume``.

Every crash-safety scenario of tests/test_checkpoint.py and
tests/test_data_checkpoint.py (a truncated npz, a garbage manifest, a
missing file, an explicit step that raises, every step corrupt,
uncommitted and ``.tmp`` directories, a re-save of the same step, prune
to ``keep``, a skeleton mismatch, uncommitted steps) runs through both
packages' ``checkpoint`` modules on the same tree, and the outcomes must
agree: which step is restored (its metadata), which exception type, the
corruption warning, the steps discovery lists.  The files on disk carry
the same names and manifest keys, apart from the structure field (JAX's
``treedef``, the port's ``paths``).  The port's own leaf types — bf16,
``None``, ``np.float32`` and ``int`` — round-trip bit for bit.

Resume == uninterrupted: through the CLI on the smoke model, 4 steps
straight against 2 steps and ``--resume`` to 4 give bit-identical logged
metrics (all but the wall time) and final checkpoints (parameters, EF
memory and every carried scalar), on the plain path, with local steps
and with bf16 EF memory.
"""
import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.convert import to_torch
from repro_torch.core.health import HealthState
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_step import init_train_state
from repro_torch.models import lm

torch.set_num_threads(2)
f32 = np.float32


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(f32),
            "b": rng.standard_normal((300,)).astype(f32),
            "opt": {"m": np.zeros((8, 8), f32), "step": np.int32(3)}}


PACKAGES = {
    "jax": (jckpt, lambda t: jax.tree.map(jnp.asarray, t),
            "repro.checkpoint.checkpoint"),
    "torch": (tckpt, to_torch, "repro_torch.checkpoint.checkpoint"),
}


def _leaves(tree) -> list:
    """numpy leaves in key order; a bf16 tensor as its 16-bit patterns."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [(tree.view(torch.int16) if tree.dtype == torch.bfloat16
                 else tree).numpy()]
    return [np.asarray(tree)]


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _truncate(d, step, name="arrays.npz"):
    p = os.path.join(d, f"step_{step:010d}", name)
    with open(p, "rb") as f:
        blob = f.read()
    with open(p, "wb") as f:
        f.write(blob[:len(blob) // 2])


def _two_committed(mod, d, tree):
    mod.save(d, 1, tree, metadata={"tag": "one"})
    mod.save(d, 2, tree, metadata={"tag": "two"})


def _sc_truncated_npz(mod, d, tree, like):
    _two_committed(mod, d, tree)
    _truncate(d, 2)
    out, meta = mod.restore(d, like)
    return meta["tag"], _same(out, tree)


def _sc_garbage_manifest(mod, d, tree, like):
    _two_committed(mod, d, tree)
    with open(os.path.join(d, "step_0000000002", "manifest.json"),
              "w") as f:
        f.write("{not json")
    return mod.restore(d, like)[1]["tag"]


def _sc_missing_file(mod, d, tree, like):
    _two_committed(mod, d, tree)
    os.remove(os.path.join(d, "step_0000000002", "arrays.npz"))
    return mod.restore(d, like)[1]["tag"]


def _sc_explicit_step_raises(mod, d, tree, like):
    _two_committed(mod, d, tree)
    _truncate(d, 2)
    try:
        mod.restore(d, like, step=2)
    except mod.CORRUPTION_ERRORS as e:
        raised = type(e).__name__
    else:
        raised = None
    return raised, mod.restore(d, like, step=1)[1]["tag"]


def _sc_every_step_corrupt(mod, d, tree, like):
    _two_committed(mod, d, tree)
    _truncate(d, 1)
    _truncate(d, 2)
    mod.restore(d, like)


def _sc_uncommitted_and_tmp_dirs(mod, d, tree, like):
    _two_committed(mod, d, tree)
    torn = os.path.join(d, "step_0000000005.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "COMMITTED"), "w") as f:
        f.write("ok")
    os.makedirs(os.path.join(d, "step_0000000006"))
    return (mod.all_steps(d), mod.latest_step(d),
            mod.restore(d, like)[1]["tag"])


def _sc_resave_same_step(mod, d, tree, like):
    _two_committed(mod, d, tree)
    mod.save(d, 2, tree, metadata={"tag": "two-redux"})
    return (mod.all_steps(d), mod.restore(d, like)[1]["tag"],
            sorted(n for n in os.listdir(d)
                   if n.endswith(".tmp") or n.endswith(".old")))


def _sc_prune_to_keep(mod, d, tree, like):
    for s in (1, 2, 3, 4, 5):
        mod.save(d, s, tree, keep=2)
    return mod.all_steps(d)


def _sc_skeleton_mismatch(mod, d, tree, like):
    mod.save(d, 1, tree)
    smaller = {k: v for k, v in like.items() if k != "b"}
    mod.restore(d, smaller)


def _sc_shape_mismatch(mod, d, tree, like):
    mod.save(d, 1, tree)
    other = dict(like, b=like["b"][:10])
    mod.restore(d, other)


def _sc_ignores_uncommitted(mod, d, tree, like):
    p = mod.save(d, 1, tree)
    os.remove(os.path.join(p, "COMMITTED"))
    return mod.all_steps(d), mod.latest_step(d)


def _sc_roundtrip_latest_and_explicit(mod, d, tree, like):
    mod.save(d, 10, tree, metadata={"step": 10})
    mod.save(d, 20, like, metadata={"step": 20})
    out, meta = mod.restore(d, tree)
    out10, meta10 = mod.restore(d, tree, step=10)
    return (mod.all_steps(d), meta["step"], _same(out, like),
            meta10["step"], _same(out10, tree))


def _sc_no_checkpoint(mod, d, tree, like):
    mod.restore(d, like)


SCENARIOS = {name[4:]: fn for name, fn in globals().items()
             if name.startswith("_sc_")}


def _outcome(pkg, scenario, tmp_path, caplog):
    mod, make, logger = PACKAGES[pkg]
    tree = make(_tree_np(0))
    like = make(_tree_np(1))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        try:
            result = ("returned", SCENARIOS[scenario](
                mod, str(tmp_path / pkg), tree, like))
        except Exception as e:     # the exception type is the outcome
            result = ("raised", type(e).__name__,
                      "corrupt" in str(e) or "no committed" in str(e))
    warned = sorted(("step_0000000002" in r.getMessage(),
                     "corrupt" in r.getMessage())
                    for r in caplog.records if r.name == logger)
    return result, warned


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_corruption_scenarios_match_jax(scenario, tmp_path, caplog):
    want = _outcome("jax", scenario, tmp_path, caplog)
    got = _outcome("torch", scenario, tmp_path, caplog)
    assert got == want
    if scenario in ("truncated_npz", "garbage_manifest", "missing_file"):
        assert want[1] == [(True, True)] and want[0][1] != ()
    if scenario in ("skeleton_mismatch", "shape_mismatch"):
        assert want[0][1] == "AssertionError"


def test_files_and_manifest_keys_match_jax(tmp_path):
    """Same file names and npz keys; the same manifest keys, apart from
    the structure field; the same leaf count, dtypes and shapes."""
    tree = _tree_np()
    pj = jckpt.save(str(tmp_path / "j"), 7, jax.tree.map(jnp.asarray, tree),
                    metadata={"step": 7})
    pt = tckpt.save(str(tmp_path / "t"), 7, to_torch(tree),
                    metadata={"step": 7})
    assert os.path.basename(pj) == os.path.basename(pt) == \
        "step_0000000007"
    assert sorted(os.listdir(pj)) == sorted(os.listdir(pt)) == \
        ["COMMITTED", "arrays.npz", "manifest.json"]
    mj, mt = (json.load(open(os.path.join(p, "manifest.json")))
              for p in (pj, pt))
    assert set(mj) - {"treedef"} == set(mt) - {"paths"}
    for k in ("step", "n_leaves", "dtypes", "shapes", "metadata"):
        assert mj[k] == mt[k], k
    assert mt["paths"] == ["b", "opt/m", "opt/step", "w"]
    zj, zt = (np.load(os.path.join(p, "arrays.npz")) for p in (pj, pt))
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k])


def test_port_leaf_types_round_trip_bit_for_bit(tmp_path):
    """bf16 tensors (stored as their uint16 bit patterns), ``None``,
    ``np.float32`` and ``int`` leaves, dataclasses, lists and tuples."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**16, 4096).astype(np.uint16)
    bits[:4] = [0x7fc1, 0xff80, 0x0001, 0x8000]       # NaN, -inf, subnormal
    bf = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    tree = {"bf": bf, "none": None, "scal": f32(0.1) / f32(3.0),
            "n": 12345678901, "health": HealthState(2, 1, 5, f32(7.0)),
            "seq": [torch.arange(5, dtype=torch.int32), (f32(1.5), 3)]}
    like = {"bf": torch.zeros_like(bf), "none": None, "scal": f32(0.0),
            "n": 0, "health": HealthState(),
            "seq": [torch.zeros(5, dtype=torch.int32), (f32(0.0), 0)]}
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, tree)
    manifest = json.load(open(os.path.join(d, "step_0000000001",
                                           "manifest.json")))
    assert manifest["dtypes"][manifest["paths"].index("bf")] == "bfloat16"
    assert manifest["dtypes"][manifest["paths"].index("none")] == "none"
    out, _ = tckpt.restore(d, like)
    assert out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["bf"].view(torch.int16), bf.view(torch.int16))
    assert out["none"] is None
    assert type(out["scal"]) is np.float32 and \
        out["scal"].view(np.int32) == tree["scal"].view(np.int32)
    assert type(out["n"]) is int and out["n"] == tree["n"]
    assert out["health"] == tree["health"]
    assert type(out["health"].rows_quarantined) is np.float32
    assert torch.equal(out["seq"][0], tree["seq"][0])
    assert type(out["seq"][1]) is tuple and out["seq"][1] == tree["seq"][1]
    # a bf16 skeleton against f32 leaves on disk is a caller bug
    with pytest.raises(AssertionError):
        tckpt.restore(d, dict(like, bf=torch.zeros(4096)))
    with pytest.raises(AssertionError):
        tckpt.restore(d, dict(like, none=torch.zeros(1)))


@pytest.mark.parametrize("kind,ef_dtype", [("csgd_asss", "bfloat16"),
                                           ("sls", "float32")])
def test_train_state_round_trips(kind, ef_dtype, tmp_path):
    """The trainer's ``{"params", "state"}`` tree: bf16 EF memory, or
    ``None`` memory for a kind that does not compress."""
    run = RunConfig(model=get_smoke_config("paper-lm-100m"),
                    shape=ShapeConfig(33, 4),
                    optimizer=OptimizerConfig(kind=kind, ef_dtype=ef_dtype))
    params = lm.init_params(run.model, seed=0)
    state = init_train_state(params, run)
    mem = state.memory
    if mem is not None:
        mem = {**mem, "embed": {"w": torch.randn(
            mem["embed"]["w"].shape).to(torch.bfloat16)}}
    state = dataclasses.replace(state, step=9, memory=mem,
                                alpha_prev=f32(0.0123))
    tckpt.save(str(tmp_path), 9, {"params": params, "state": state})
    skel_params = lm.init_params(run.model, seed=1)
    out, _ = tckpt.restore(str(tmp_path), {
        "params": skel_params, "state": init_train_state(skel_params, run)})
    assert out["state"].step == 9 and out["state"].alpha_prev == f32(0.0123)
    assert (out["state"].memory is None) == (kind == "sls")
    for a, b in zip(_leaves({"p": params, "m": mem or {}}),
                    _leaves({"p": out["params"],
                             "m": out["state"].memory or {}})):
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


SMOKE = ["--device", "cpu", "--smoke", "--seq-len", "33", "--global-batch",
         "4", "--compress-method", "block_topk", "--log-every", "1"]


def _final(d) -> tuple:
    """The manifest and the arrays of the newest checkpoint in ``d``."""
    d = os.path.join(d, "rank_000")
    p = os.path.join(d, f"step_{tckpt.latest_step(d):010d}")
    manifest = json.load(open(os.path.join(p, "manifest.json")))
    z = np.load(os.path.join(p, "arrays.npz"))
    return manifest, {k: z[k] for k in z.files}


def _metrics(log):
    return [{k: v for k, v in m.items() if k != "step_s"} for m in log]


@pytest.mark.parametrize("extra", [
    [], ["--local-steps", "2", "--microbatches", "2"],
    ["--ef-dtype", "bfloat16", "--transport", "perleaf"]],
    ids=["plain", "local-steps", "bf16-ef"])
def test_resume_equals_uninterrupted(extra, tmp_path, capsys):
    """4 steps straight against 2, then ``--resume`` to 4: the resumed
    run starts at step 2 and logs steps 2 and 3, and every logged metric
    and the final checkpoint (parameters, EF memory, every carried
    scalar) are bit-identical to the uninterrupted run's."""
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    log = train_cli.main(SMOKE + extra + ["--steps", "4", "--ckpt-dir",
                                          straight, "--ckpt-every", "2"])
    first = train_cli.main(SMOKE + extra + ["--steps", "2", "--ckpt-dir",
                                            split, "--ckpt-every", "1"])
    assert tckpt.all_steps(os.path.join(split, "rank_000")) == [1, 2]
    capsys.readouterr()
    second = train_cli.main(SMOKE + extra + ["--steps", "4", "--ckpt-dir",
                                             split, "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [m["step"] for m in second] == [2, 3]
    assert _metrics(first + second) == _metrics(log)
    (ms, zs), (mr, zr) = _final(straight), _final(split)
    assert ms == mr and ms["metadata"] == {"step": 4, "world_size": 1}
    assert sorted(zs) == sorted(zr)
    for k in zs:
        np.testing.assert_array_equal(np.atleast_1d(zs[k]).view(np.uint8),
                                      np.atleast_1d(zr[k]).view(np.uint8),
                                      err_msg=k)
    if "bfloat16" in extra:
        mem = [dt for p, dt in zip(ms["paths"], ms["dtypes"])
               if p.startswith("state/memory/")]
        assert mem and set(mem) == {"bfloat16"}


def test_resume_without_a_checkpoint_and_at_step_0(tmp_path, capsys):
    """``--resume`` with no checkpoint starts at step 0; a checkpoint at
    step 0 (``--steps 0``) is restored, not taken for none (the CLI
    tests ``latest_step(...) is not None``)."""
    d = str(tmp_path / "ck")
    log = train_cli.main(SMOKE + ["--steps", "1", "--ckpt-dir", d,
                                  "--resume"])
    assert [m["step"] for m in log] == [0]
    d0 = str(tmp_path / "ck0")
    assert train_cli.main(SMOKE + ["--steps", "0", "--ckpt-dir", d0]) == []
    assert tckpt.all_steps(os.path.join(d0, "rank_000")) == [0]
    capsys.readouterr()
    log = train_cli.main(SMOKE + ["--steps", "1", "--ckpt-dir", d0,
                                  "--resume"])
    assert "resumed from step 0" in capsys.readouterr().out
    assert [m["step"] for m in log] == [0]


def test_resume_falls_back_past_a_torn_checkpoint(tmp_path, caplog):
    """The newest step torn on disk: ``--resume`` warns and resumes from
    the one before, as ``restore`` falls back."""
    d = str(tmp_path / "ck")
    train_cli.main(SMOKE + ["--steps", "3", "--ckpt-dir", d,
                            "--ckpt-every", "1"])
    _truncate(os.path.join(d, "rank_000"), 3)
    with caplog.at_level(logging.WARNING):
        log = train_cli.main(SMOKE + ["--steps", "3", "--ckpt-dir", d,
                                      "--resume"])
    assert [m["step"] for m in log] == [2]
    assert any("step_0000000003" in r.getMessage() for r in caplog.records)
