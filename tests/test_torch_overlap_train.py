"""The trainer's plain round on the overlap transport (``--transport
overlap``) against the JAX package: 3 rounds of the smoke config at
delay 0 and 1, for ``csgd_asss`` and ``nonadaptive``, against the jitted
reference round of tests/torch_trainer_ref.py (its overlap seam), each
round from the reference's parameters, EF memory and carried payload, at
the tolerances stated there; ``staleness``, the byte counts and the
carried effective bytes exact.  The collectives posted at the start of
the step equal a late post bit for bit.  The local-steps round, the
breaker, checkpoints and the CLI: tests/test_torch_overlap_runtime.py.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import exchange
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train_step as ts
from repro_torch.models import lm

import torch_trainer_ref as ref

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ref.overlap_cases(1), ids=ref.case_id)
def test_overlap_rounds_match_jax(case):
    ref.check_overlap_rounds(case)


def _steps(run, n):
    params = lm.init_params(run.model, seed=0)
    state = ts.init_train_state(params, run)
    pipe = TokenPipeline(vocab_size=run.model.vocab_size, seq_len=ref.SEQ,
                         global_batch=ref.BATCH)
    out = []
    for t in range(n):
        params, state, m = ts.train_step(params, state, pipe.batch(t), run)
        out.append((params, state, m))
    return out


def test_early_start_equals_late_start(monkeypatch):
    """Posting the carried buffers' collectives before the gradient (in
    the ``train_step.overlap_start`` span) or only when the exchange
    decodes gives the same bits: parameters, state and metrics."""
    run = ref.overlap_run(local_steps=1)
    posted = []
    real = ts.post_carried
    monkeypatch.setattr(ts, "post_carried", lambda *a: posted.append(1)
                        or real(*a))
    early = _steps(run, 3)
    assert len(posted) == 3
    monkeypatch.setattr(ts, "_overlap_start", lambda *a: None)
    late = _steps(run, 3)
    for (p1, s1, m1), (p2, s2, m2) in zip(early, late):
        ref.assert_bitwise_equal(p1, p2)
        ref.assert_bitwise_equal(s1, s2)
        assert m1 == m2


def test_delay0_posts_nothing_early(monkeypatch):
    posted = []
    monkeypatch.setattr(ts, "post_carried", lambda *a: posted.append(1))
    _steps(ref.overlap_run(delay=0), 2)
    assert posted == []
