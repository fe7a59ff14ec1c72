"""Rematerialisation (``ModelConfig.remat``) in the port, on the CPU.

JAX wraps each scan body in ``jax.checkpoint`` under ``remat``: one
layer (dense, MoE, RWKV-6, Mamba2; each encoder and decoder layer of the
encoder-decoder), one group of a hybrid (``shared_attn_every`` Mamba2
layers and the shared block; its tail layers unwrapped) or of a vlm
(``cross_attn_every`` dense layers and the cross block).  The port wraps
the same units in ``torch.utils.checkpoint`` while autograd records.

* For every family's smoke, ``remat=True`` against ``remat=False`` in
  the port: the loss and every gradient bit for bit, and one trainer
  step through the CLI's ``train.run`` (its parameters, EF memory and
  metrics) bit for bit; the checkpoints entered are JAX's units.
* ``remat=True`` in both packages, 2 trainer rounds of the MoE (its aux
  losses summed across the units) and vlm smokes through
  ``tests/torch_trainer_ref.py``'s ``Case(arch=, remat=True)``, to that
  file's tolerances.
* Serving (``torch.inference_mode``) and the Armijo trials
  (``torch.no_grad``) enter no checkpoint: ``torch.utils.checkpoint.
  checkpoint`` is patched to count its calls.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.utils.checkpoint

import torch_trainer_ref as ref
from repro_torch.comm import exchange
from repro_torch.configs import get_smoke_config
from repro_torch.core.armijo import ArmijoConfig, armijo_search
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.utils import tree_flatten, value_and_grad

torch.set_num_threads(2)

#: (test id, arch, fields replaced, the units JAX's jax.checkpoint wraps)
FAMILIES = [("dense", "qwen1.5-4b", {}, 2),
            ("moe", "granite-moe-1b-a400m", {}, 2),
            ("rwkv", "rwkv6-1.6b", {}, 2),
            ("mamba2", "zamba2-7b", dict(family="ssm", name="mamba2-x",
                                         n_layers=2, shared_attn_every=0), 2),
            ("hybrid", "zamba2-7b", {}, 2),        # 2 groups; the tail bare
            ("encdec", "seamless-m4t-large-v2", {}, 4),    # 2 + 2 layers
            ("vlm", "llama-3.2-vision-11b", {}, 2)]        # 2 groups
IDS = [f[0] for f in FAMILIES]


@pytest.fixture
def count_checkpoints(monkeypatch):
    """Counts the calls of ``torch.utils.checkpoint.checkpoint``."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    return calls


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def _model(arch, kw, remat):
    return build_model(dataclasses.replace(get_smoke_config(arch), **kw,
                                           remat=remat))


def _live(params):
    """A vlm's gates (0 at init, which keeps the cross blocks out of the
    loss and their gradient) set to values in [0.5, 1)."""
    if "cross" in params:
        gen = torch.Generator().manual_seed(11)
        for k in ("gate_attn", "gate_mlp"):
            g = params["cross"][k]
            g.copy_(torch.rand(g.shape, generator=gen) * 0.5 + 0.5)
    return params


def _batch(cfg, seed=1):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 33),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["src_embed"] = torch.randn((2, 32, cfg.d_model), generator=gen)
    if cfg.family == "vlm":
        batch["image_embed"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                           generator=gen)
    return batch


def _bits_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("_, arch, kw, units", FAMILIES, ids=IDS)
def test_gradients_bit_for_bit(_, arch, kw, units, count_checkpoints):
    plain, remat = _model(arch, kw, False), _model(arch, kw, True)
    params = _live(plain.init(0))
    batch = _batch(plain.cfg)
    loss0, g0 = value_and_grad(lambda p: plain.loss(p, batch), params)
    assert not count_checkpoints
    loss1, g1 = value_and_grad(lambda p: remat.loss(p, batch), params)
    assert len(count_checkpoints) == units
    assert all(kw == dict(use_reentrant=False, preserve_rng_state=False)
               for kw in count_checkpoints)
    assert torch.equal(loss0, loss1) and _bits_equal(g0, g1)
    assert any(bool(g.any()) for g in tree_flatten(g1)[0])


@pytest.mark.parametrize("_, arch, kw, units", FAMILIES, ids=IDS)
def test_trainer_step_bit_for_bit(_, arch, kw, units, group,
                                  count_checkpoints, monkeypatch):
    """One DCSGD-ASSS step through ``train.run``, ``remat`` replaced in
    the smoke config: the parameters, the EF memory and the metrics the
    same bits (the Armijo trials under ``no_grad`` enter no checkpoint:
    the checkpoints entered are the gradient pass's units alone)."""
    # the launcher's --arch takes no qwen1.5-4b, rwkv6-1.6b or pure
    # Mamba2 model: each family's smoke config comes in through its lookup
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    monkeypatch.setattr(train, "get_smoke_config", lambda _: cfg)
    build = train.build_model

    def live_build(cfg):
        model = build(cfg)
        return dataclasses.replace(model, init=lambda seed=0, **k: _live(
            model.init(seed, **k)))
    monkeypatch.setattr(train, "build_model", live_build)
    argv = ["--device", "cpu", "--smoke", "--steps", "1",
            "--seq-len", "33", "--global-batch", "4", "--compress-method",
            "block_topk", "--log-every", "1"]
    runs = {}
    for remat in (False, True):
        del count_checkpoints[:]
        runs[remat] = train.run(argv, remat=remat)
        assert len(count_checkpoints) == (units if remat else 0)
    (log0, p0, s0), (log1, p1, s1) = runs[False], runs[True]
    assert log1[0]["n_evals"] >= 1
    assert _bits_equal(p0, p1) and _bits_equal(s0.memory, s1.memory)
    for k in ("loss", "alpha", "n_evals", "wire_bytes", "gamma"):
        assert log0[0][k] == log1[0][k], k


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama-3.2-vision-11b"])
def test_remat_rounds_match_jax(arch, group):
    """2 trainer rounds with ``remat=True`` in both packages (JAX's
    ``jax.checkpoint`` around each group's scan body), each from the
    reference's parameters and EF memory, to ``torch_trainer_ref``'s
    tolerances."""
    case = ref.Case("csgd_asss", arch=arch, remat=True)
    assert case.run().model.remat and ref.jax_model(arch, True)[0].cfg.remat
    _, _, log = ref.run_both(case, steps=2)
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)


def test_serving_and_armijo_enter_no_checkpoint(count_checkpoints):
    """Under ``inference_mode`` (serving) and ``no_grad`` (the Armijo
    trials) a ``remat=True`` model runs its plain forward."""
    for _, arch, kw, _ in FAMILIES:
        model = _model(arch, kw, True)
        params = _live(model.init(0))
        batch = _batch(model.cfg)
        with torch.inference_mode():
            logits, cache = model.prefill(params, batch, capacity=40)
            model.decode_step(params, logits[:, -1:].argmax(-1), cache, 33)
            model.loss(params, batch)
        loss, grads = value_and_grad(lambda p: model.loss(p, batch), params)
        del count_checkpoints[:]
        res = armijo_search(lambda p: model.loss(p, batch), params, grads,
                            1.0, ArmijoConfig(), f0=loss)
        assert res.n_evals >= 1
        assert not count_checkpoints, arch
