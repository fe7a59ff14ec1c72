"""The port's server on a data axis alone (``--mesh 2x1``, with and
without ``--params-2d``) for the families that take no model axis yet:
RWKV-6, the Mamba2 hybrid, the encoder-decoder and the vlm, against the
JAX package's UNSHARDED prefill and decode, on the CPU.

Each case is its arch's smoke widened as tests/test_torch_tp_serve.py's
GQA variant is (vocab 8192, d_ff 4096; the hybrid's d_ff 8192, so that
its shared block's MLP is cut too): its embedding, head and MLP weights
reach JAX's ``widen`` size, 2^20 elements, and ``--params-2d`` cuts
them over data.  The ranks then gather them layer by layer: a stacked
(L, ...) leaf, a vlm's (group, layer) leaf and its cross blocks, the
hybrid's shared block, the encoder's and the decoder's blocks.  The two
ranks of the mesh are spawned once and serve every case, each its one
row of the batch of 2.

JAX runs jitted with no mesh, with tests/test_torch_tp_serve.py's
weights (JAX's init, constant leaves perturbed: a vlm's gates live),
carried over by ``convert.to_torch`` and cut by ``shard_params``.
Tolerances as test_torch_serve.py's: each rank's logits (its row) within
1e-4 of max|logits|, greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from test_torch_tp_serve import _close, _perturbed
from torch_overlap_workers import Spawned
from torch_tp_workers import serve_cases

torch.set_num_threads(2)

WIDE = dict(vocab_size=8192, d_ff=4096)
#: (id, arch, fields replaced in both smoke configs)
CASES = [("rwkv", "rwkv6-1.6b", WIDE),
         ("hybrid", "zamba2-7b", dict(WIDE, d_ff=8192)),
         ("encdec", "seamless-m4t-large-v2", WIDE),
         ("vlm", "llama-3.2-vision-11b", WIDE)]
SHAPE = (2, 1)
B, CTX, N_DECODE = 2, 24, 3


def _batch(cfg, rng) -> dict:
    """The prompt, and an encoder-decoder's source frames or a vlm's
    image patches (numpy)."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, CTX)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["src_embed"] = rng.standard_normal(
            (B, serve.SRC_FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embed"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax_serve(jcfg, params, batch, cap):
    """JAX's unsharded prefill + N_DECODE greedy steps, jitted."""
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, capacity=cap))(
        jp, jax.tree.map(jnp.asarray, batch))
    decode = jax.jit(jm.decode_step)
    out = dict(logits=[np.asarray(logits[:, -1])], tokens=[])
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache, jnp.int32(CTX + i))
        out["logits"].append(np.asarray(logits[:, -1]))
    return out


@pytest.fixture(scope="module")
def runs():
    """The mesh's ranks started on every case; JAX's references
    meanwhile.  Returns (JAX's results by case, {rank: worker results})."""
    cap = CTX + N_DECODE + 1
    rng = np.random.default_rng(4)
    cases, jcfgs = [], {}
    for name, arch, kw in CASES:
        jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
        cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True,
                                  **kw)
        params = _perturbed(jax_build_model(jcfg).init(
            jax.random.PRNGKey(0)), 3)
        cases.append((name, cfg, params, _batch(cfg, rng), cap, N_DECODE))
        jcfgs[name] = jcfg
    spawned = Spawned(serve_cases, SHAPE[0] * SHAPE[1], SHAPE, cases)
    want = {name: dict(_jax_serve(jcfgs[name], params, batch, cap),
                       vocab=jcfgs[name].vocab_size)
            for name, _, params, batch, *_ in cases}
    return want, spawned.result(timeout=300)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_data_axis_serves_like_jax(runs, name, two_d):
    want, got = runs
    want = want[name]
    vocab = want["vocab"]
    for rank, res in got.items():
        res = res[(name, two_d)]
        rows = slice(rank, rank + 1)       # 2x1: the data index is the rank
        assert (res["widened"] > 0) == two_d
        assert len(res["logits"]) == len(want["logits"])
        for g, w in zip(res["logits"], want["logits"]):
            assert g.shape == w[rows].shape
            _close(g[:, :vocab], w[rows, :vocab], 1e-4)
        for g, w in zip(res["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[rows])
