"""The federated cohort on the encoder-decoder family: 3 rounds of a
2-client cohort of the seamless-m4t-large-v2 smoke model (DCSGD-ASSS at
gamma 0.01, both clients every round) against the jitted composition of
JAX's ``_federated_worker`` in tests/torch_trainer_ref.py, each round
from the reference's parameters and client state, on the CPU.  Each
client's gradients and Armijo search run on its own rows of every key
of the batch, ``tokens`` and ``src_embed`` (stacked per client as the
CLI stacks them).  Tolerances as in tests/test_torch_fed_train.py: loss,
gradient norm and alpha rel 1e-5, parameters and every client's EF
memory within 1e-5 of the leaf's max; gamma_t, n_evals and bytes exact.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_trainer_ref as ref
from repro_torch.comm import exchange

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def group():
    created = exchange.init_process_group(torch.device("cpu"))
    yield
    if created:
        dist.destroy_process_group()


def test_cohort_rounds_match_jax(group):
    case = ref.FedCase(arch=ARCH, n_clients=2, clients_per_round=2)
    aux = case.aux(0)["src_embed"]
    assert aux.shape == (2, ref.FED_BATCH // 2, ref.SEQ, 128)
    assert aux.dtype == np.float32
    log = ref.run_fed_both(case, (case,))
    assert [m["participants"] for m in log] == [2.0] * ref.STEPS
    assert all(np.isfinite(m["loss"]) and m["n_evals"] >= 1 for m in log)
