"""The port's server under a mesh (``launch/mesh.py``, ``sharding.py``,
the model axis of ``models/``) against the JAX package's UNSHARDED
prefill and decode, on the CPU.

Meshes 1x2, 2x1 and 2x2 (data x model) run as 2, 2 and 4 gloo ranks,
each spawned once; inside, every rank serves each case with
``--params-2d`` off and on (``serve.shard`` then ``Model.prefill`` and
4 greedy ``decode_step``s).  The cases: qwen1.5-4b's smoke; a GQA
variant (2 kv heads of 4, vocab 8192, d_ff 4096: its embedding, head
and MLP weights reach JAX's ``widen`` size, 2^20 elements, so
``--params-2d`` cuts them over data and gathers them layer by layer);
the smoke with tied embeddings (the head row-parallel); granite-moe's
smoke with ``moe_expert_parallel`` off and on (drop-free at its
capacity factor 2, so the flag changes nothing here:
tests/test_torch_moe_ep.py holds the capacity rule).

JAX runs jitted with no mesh (its LM steps under a mesh fail on JAX
0.9.0, ROADMAP queue 3), with the weights of tests/test_torch_serve.py
(JAX's init, constant leaves perturbed), carried over by
``convert.to_torch`` and cut by ``shard_params``.  Tolerances as
test_torch_serve.py's: each rank's logits (its rows, gathered along the
vocab) within 1e-4 of max|logits|, its caches (its rows and kv heads)
within 1e-5 of max, greedy tokens equal.

Also: ``--mesh 1x1`` serves bit for bit what the one-process path
serves; the refusals of ``ModelConfig.check_mesh`` and ``shard_params``;
a world size other than the mesh's; the backend rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch import sharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.models import build_model
from torch_overlap_workers import Spawned
from torch_tp_workers import serve_cases

torch.set_num_threads(2)

#: (id, arch, fields replaced in both smoke configs)
CASES = [("qwen", "qwen1.5-4b", {}),
         ("qwen-gqa-wide", "qwen1.5-4b",
          dict(n_kv_heads=2, vocab_size=8192, d_ff=4096)),
         ("qwen-tied", "qwen1.5-4b", dict(tie_embeddings=True)),
         ("granite", "granite-moe-1b-a400m", {}),
         ("granite-ep", "granite-moe-1b-a400m",
          dict(moe_expert_parallel=True))]
MESHES = [(1, 2), (2, 1), (2, 2)]
B, CTX, N_DECODE = 2, 96, 4


def _perturbed(tree, seed):
    """JAX's init as numpy, every constant leaf given a small random
    part (tests/test_torch_serve.py's weights)."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size > 1 and np.all(x == x.reshape(-1)[0]):
            x = x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _jax_serve(jcfg, params, prompt, cap):
    """JAX's unsharded prefill + N_DECODE greedy steps, jitted."""
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, capacity=cap))(jp, jnp.asarray(prompt))
    decode = jax.jit(jm.decode_step)
    out = dict(logits=[np.asarray(logits[:, -1])], tokens=[],
               caches=[(np.asarray(cache.kv.k), np.asarray(cache.kv.v))])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(CTX + i))
        out["logits"].append(np.asarray(logits[:, -1]))
    out["caches"].append((np.asarray(cache.kv.k), np.asarray(cache.kv.v)))
    return out


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks started at once on every case; JAX's
    references meanwhile.  Returns (JAX's results by case, {mesh: {rank:
    worker results}})."""
    cap = CTX + N_DECODE + 1
    prompt = np.random.default_rng(4).integers(0, 512, (B, CTX)).astype(
        np.int32)
    cases, jcfgs = [], {}
    for name, arch, kw in CASES:
        jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
        cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True,
                                  **kw)
        params = _perturbed(jax_build_model(jcfg).init(
            jax.random.PRNGKey(0)), 3)
        cases.append((name, cfg, params, {"tokens": prompt}, cap,
                      N_DECODE))
        jcfgs[name] = jcfg
    spawned = {shape: Spawned(serve_cases, shape[0] * shape[1], shape, cases)
               for shape in MESHES}
    want = {name: dict(_jax_serve(jcfgs[name], params, prompt, cap),
                       vocab=jcfgs[name].vocab_size)
            for name, _, params, *_ in cases}
    return want, {shape: s.result(timeout=300)
                  for shape, s in spawned.items()}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1", "2x2"])
def test_mesh_serves_like_jax(runs, shape, name, two_d):
    want, got = runs
    want = want[name]
    D, M = shape
    vocab = want["vocab"]
    for rank, res in got[shape].items():
        dp, m = mesh_mod.mesh_coords(shape, rank)
        res = res[(name, two_d)]
        rows = slice(dp * B // D, (dp + 1) * B // D)
        assert (res["widened"] > 0) == (two_d and D > 1
                                        and name == "qwen-gqa-wide")
        assert len(res["logits"]) == len(want["logits"])
        for g, w in zip(res["logits"], want["logits"]):
            assert g.shape == w[rows].shape
            _close(g[:, :vocab], w[rows, :vocab], 1e-4)
        for g, w in zip(res["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
        for (gk, gv), (wk, wv) in zip(res["caches"], want["caches"]):
            h = wk.shape[3] // M
            heads = slice(m * h, (m + 1) * h)
            for g, w in ((gk, wk), (gv, wv)):
                assert g.shape == w[:, rows, :, heads].shape
                _close(g, w[:, rows, :, heads], 1e-5)


def test_mesh_1x1_serves_bit_for_bit_the_one_process_path():
    args = ["--device", "cpu", "--smoke", "--arch", "granite-moe-1b-a400m",
            "--batch", "2", "--ctx", "40", "--gen", "4"]
    res = serve.main(args + ["--mesh", "1x1", "--params-2d"])
    model, params, batch = serve.load("granite-moe-1b-a400m", True, 2, 40,
                                      "cpu")
    plain = serve.generate(model, params, batch, 4)
    assert torch.equal(res["tokens"], plain["tokens"])
    assert torch.equal(res["logits"], plain["logits"])
    assert res["weight_bytes"] == sharding.tensor_bytes(params)


def _mesh(shape, rank=0):
    """A mesh object alone (no process group): for the checks that run
    before any collective."""
    return mesh_mod.Mesh(tuple(shape), mesh_mod.AXES_2D, rank)


@pytest.mark.parametrize("kw, match", [
    (dict(n_heads=3, head_dim=32), "n_heads=3"),
    (dict(n_kv_heads=1), "n_kv_heads=1"),
    (dict(d_model=129), "d_model=129"),
    (dict(d_ff=251), "d_ff=251"),
])
def test_indivisible_model_cuts_raise(kw, match):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"), **kw)
    with pytest.raises(ValueError, match=match):
        cfg.check_mesh(2, 1)
    cfg.check_mesh(1, 2)                 # no model axis: nothing is cut


def test_indivisible_vocab_experts_and_batch_raise():
    six = dataclasses.replace(get_smoke_config("qwen1.5-4b"), n_heads=6,
                              n_kv_heads=6, d_model=192, d_ff=384)
    with pytest.raises(ValueError, match="padded_vocab=512"):
        six.check_mesh(3, 1)
    moe_cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                                  n_experts=6)
    with pytest.raises(ValueError, match="n_experts=6"):
        moe_cfg.check_mesh(4, 1)
    model = build_model(get_smoke_config("qwen1.5-4b"))
    params = model.init(0)
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="batch 3"):
        serve.shard(model, params, batch, _mesh((2, 1)))
    # --params-2d: a widened dim that the data axis does not divide
    wide = build_model(dataclasses.replace(get_smoke_config("qwen1.5-4b"),
                                           vocab_size=8192))
    with pytest.raises(ValueError, match="cannot be cut in 3"):
        sharding.shard_params(wide.init(0), _mesh((3, 1)), two_d=True)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_other_families_refuse_a_model_axis(arch):
    """Every family but dense and MoE raises at a model axis of 2, from
    the config and from the model's entry point, naming the ROADMAP
    item; at a model axis of 1 with a data axis it serves."""
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 6"):
        cfg.check_mesh(2, 1)
    model = build_model(cfg)
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 6"):
        model.prefill(model.init(0), {"tokens": torch.zeros(
            (1, 8), dtype=torch.long)}, mesh=_mesh((1, 2)))
    cfg.check_mesh(1, 2, batch=4)


def test_world_size_other_than_the_mesh_raises():
    with pytest.raises(ValueError, match="takes 2 ranks"):
        serve.main(["--device", "cpu", "--smoke", "--mesh", "1x2",
                    "--batch", "2", "--ctx", "8", "--gen", "2"])


def test_parse_mesh_and_backend_rule(monkeypatch):
    assert mesh_mod.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert mesh_mod.parse_mesh("2x16x16") == ((2, 16, 16),
                                              ("pod", "data", "model"))
    for bad in ("4", "2x0", "ax2", "1x1x1x1"):
        with pytest.raises(ValueError):
            mesh_mod.parse_mesh(bad)
    assert mesh_mod.backend_for(torch.device("cpu"), 4) == "gloo"
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.backend_for(cuda, 2) == "gloo"      # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_mod.backend_for(cuda, 4) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert mesh_mod.backend_for(cuda, 16) == "gloo"


def test_full_size_shards_hold_exact_bytes():
    """Each rank's resident weights at the full widths (fake tensors),
    bf16 as configured and f32: the bytes phase 4r of chip_smoke.py
    checks on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = {("qwen1.5-4b", (1, 2), False, None): 3_951_232_000,
            ("qwen1.5-4b", (2, 1), True, None): 3_951_539_200,
            ("granite-moe-1b-a400m", (1, 2), False, None): 1_387_890_688,
            ("qwen1.5-4b", (1, 2), False, "float32"): 7_902_464_000,
            # the f32 router is the same 3,145,728 B in either tree
            ("granite-moe-1b-a400m", (1, 2), False, "float32"):
                2_772_635_648}
    with FakeTensorMode():
        for (arch, shape, two_d, dtype), n in want.items():
            cfg = get_config(arch)
            if dtype:
                cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                          compute_dtype=dtype)
            params = build_model(cfg).init(0)
            for rank in range(2):
                local = sharding.shard_params(params, _mesh(shape, rank),
                                              two_d)
                assert sharding.tensor_bytes(local) == n
