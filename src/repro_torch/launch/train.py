"""Training entry point of the port: the data-parallel trainer on the
process group (twin of ``src/repro/launch/train.py``, the flags of its
plain path on the ``bucketed`` and ``perleaf`` transports, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --compress-method block_topk --steps 4

runs DCSGD-ASSS on paper-lm-100m on the GPU; ``--smoke --device cpu``
runs the 2-layer variant on the CPU with the kernels' plain versions.
Several GPUs: ``torchrun --nproc-per-node N -m repro_torch.launch.train
...`` (one process per GPU; each takes its rows of the global batch).
Without CUDA and without ``--device cpu`` it raises: it never falls
back.

``--opt`` picks the optimizer: ``csgd_asss`` (default), ``nonadaptive``
(the same EF compression at the constant step ``--eta``), ``sls`` (the
Armijo search with a dense exchange), ``sgd`` or ``dense`` (a dense
exchange at ``--eta``).  ``--microbatches M`` sums each worker's
gradient over M row groups of its batch.  ``--max-consecutive-skips N``
raises ``DivergenceError`` after N consecutive non-finite steps (0
writes them through).

The adaptive budget: ``--max-gamma 0.1 --gamma-schedule linear`` (or
``armijo-coupled``, ``ef-coupled``) compresses each round at the
controller's gamma_t inside payload rows sized for 10%;
``--transport perleaf`` encodes them leaf by leaf through the ragged
pack/unpack kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.comm.exchange import init_process_group
from repro_torch.comm.transport import transport_names
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import KINDS, OptimizerConfig, RunConfig, \
    ShapeConfig
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import SCHEDULES, GammaControllerConfig
from repro_torch.core.health import check_divergence
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import lm


def resolve_device(name: str) -> torch.device:
    """``cuda`` (this process's local GPU under torchrun) or ``cpu``; no
    fallback from one to the other."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r} (want cuda | cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch path on the CPU")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-100m",
                    choices=["paper-lm-100m"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced 2-layer variant of --arch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt", default="csgd_asss", choices=list(KINDS))
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--compress-method", default="topk",
                    choices=["topk", "block_topk", "none"],
                    help="block_topk = fused CUDA kernel path")
    ap.add_argument("--eta", type=float, default=0.1)
    # ---- adaptive per-round compression (DESIGN.md §9) ----
    ap.add_argument("--max-gamma", type=float, default=0.0,
                    help="> 0: static ragged-wire budget; gamma becomes "
                         "the per-round initial level")
    ap.add_argument("--gamma-schedule", default="fixed",
                    choices=list(SCHEDULES),
                    help="per-round gamma controller (core/gamma.py); "
                         "ef-coupled couples to the EF backlog telemetry "
                         "(DESIGN.md §10)")
    ap.add_argument("--gamma-min", type=float, default=0.0,
                    help="controller floor (0 = gamma/8)")
    ap.add_argument("--gamma-ramp-steps", type=int, default=1000,
                    help="linear schedule: steps from gamma to max-gamma")
    ap.add_argument("--ef-target", type=float,
                    default=GammaControllerConfig.ef_target,
                    help="ef-coupled: backlog ratio ||m'||/||g|| the "
                         "hysteresis band centers on")
    ap.add_argument("--ef-band", type=float,
                    default=GammaControllerConfig.ef_band,
                    help="ef-coupled: band half-width (grow above "
                         "target+band, shrink below target-band)")
    ap.add_argument("--theory-safe", action="store_true",
                    help="clamp the step scale to zeta(gamma_t) = "
                         "sigma*gamma/(2-gamma) each round")
    ap.add_argument("--value-bits", type=int, default=32,
                    choices=[32, 16, 8, 4],
                    help="wire value width (DESIGN.md §8 packed format)")
    ap.add_argument("--transport", default="bucketed",
                    choices=list(transport_names()),
                    help="compressed-exchange schedule: bucketed = ONE "
                         "flat packed all_gather + batched launches; "
                         "perleaf = one collective per leaf (bit-exact "
                         "reference; the ragged kernels when adaptive)")
    ap.add_argument("--max-consecutive-skips", type=int,
                    default=OptimizerConfig.max_consecutive_skips,
                    help="step-level circuit breaker: this many consecutive "
                         "non-finite (skipped) rounds raise "
                         "DivergenceError naming the last good step "
                         "(0 disables the gate)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON metrics log")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the CLI; returns the logged metrics (one dict per logged step,
    with ``step`` and ``step_s``, the step's wall seconds)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(
        model=cfg, shape=ShapeConfig(args.seq_len, args.global_batch),
        microbatches=args.microbatches,
        optimizer=OptimizerConfig(
            kind=args.opt, eta=args.eta,
            max_consecutive_skips=args.max_consecutive_skips,
            armijo=ArmijoConfig(theory_safe=args.theory_safe),
            compressor=Compressor(
                gamma=args.gamma, method=args.compress_method,
                value_bits=args.value_bits, max_gamma=args.max_gamma),
            gamma_controller=GammaControllerConfig(
                schedule=args.gamma_schedule, gamma_min=args.gamma_min,
                ramp_steps=args.gamma_ramp_steps, ef_target=args.ef_target,
                ef_band=args.ef_band),
            transport=args.transport))

    created = init_process_group(device)
    try:
        W, rank = dist.get_world_size(), dist.get_rank()
        B = run.shape.global_batch
        if B % W:
            raise SystemExit(f"--global-batch {B} does not split over {W} "
                             "workers")
        rows = slice(rank * B // W, (rank + 1) * B // W)
        params = lm.init_params(cfg, seed=0, device=device)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size,
                             seq_len=run.shape.seq_len, global_batch=B)
        log = []
        for step in range(args.steps):
            batch = {k: v[rows].to(device)
                     for k, v in pipe.batch(step).items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            params, state, m = train_step(params, state, batch, run)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            m["step"] = step
            m["step_s"] = time.perf_counter() - t0
            # host-side breaker, as the JAX trainer's loop runs it
            check_divergence(m, run.optimizer.max_consecutive_skips)
            if step % args.log_every == 0 or step == args.steps - 1:
                log.append(m)
                if rank == 0:
                    print(f"step {step:5d} loss={m['loss']:.4f} "
                          f"alpha={m['alpha']:.4g} evals={m['n_evals']:.2f} "
                          f"up={m['wire_bytes']:.3e}B "
                          f"eff={m['effective_wire_bytes']:.3e}B "
                          f"cum={m['cum_effective_wire_bytes']:.3e}B "
                          f"gamma={m['gamma']:.4g} "
                          f"backlog={m['ef_backlog']:.3g} "
                          f"cos={m['ef_cosine']:.3f} "
                          f"step_s={m['step_s']:.3f}"
                          + (f" skips={m['steps_skipped']:.0f}"
                             f" quar={m['rows_quarantined']:.0f}"
                             if m["steps_skipped"] or m["rows_quarantined"]
                             else ""), flush=True)
        if args.out and rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(log, f, indent=1)
        return log
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
