"""Training entry point of the port: the data-parallel trainer on the
process group (twin of ``src/repro/launch/train.py``, the flags of its
plain path on the ``bucketed``, ``perleaf``, ``overlap`` and ``gossip``
transports, its fault flags and its federated cohort's flags, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --compress-method block_topk --steps 4

runs DCSGD-ASSS on paper-lm-100m on the GPU (``--arch
granite-moe-1b-a400m``: the MoE model, ``--arch zamba2-7b``: the hybrid
Mamba2 model, ``--arch seamless-m4t-large-v2``: the encoder-decoder,
whose batches carry ``src_embed`` frames beside the tokens, ``--arch
llama-3.2-vision-11b``: the vlm, whose batches carry ``image_embed``
patches, all with bf16 parameters and JAX's f32 update);
``--smoke --device cpu`` runs the reduced variant on the CPU with the
kernels' plain versions.
Several GPUs: ``torchrun --nproc-per-node N -m repro_torch.launch.train
...`` (one process per GPU; each takes its rows of the global batch).
Without CUDA and without ``--device cpu`` it raises: it never falls
back.

``--opt`` picks the optimizer: ``csgd_asss`` (default), ``nonadaptive``
(the same EF compression at the constant step ``--eta``), ``acgd`` (the
same on the Nesterov direction, ``--momentum`` mu), ``sls`` (the Armijo
search with a dense exchange), ``sgd`` or ``dense`` (a dense exchange
at ``--eta``).  ``--microbatches M`` sums each worker's
gradient over M row groups of its batch.  ``--max-consecutive-skips N``
raises ``DivergenceError`` after N consecutive non-finite steps (0
writes them through).

The adaptive budget: ``--max-gamma 0.1 --gamma-schedule linear`` (or
``armijo-coupled``, ``ef-coupled``) compresses each round at the
controller's gamma_t inside payload rows sized for 10%;
``--transport perleaf`` encodes them leaf by leaf through the ragged
pack/unpack kernels.

``--local-steps H --microbatches H`` takes H local Armijo-SGD steps a
round and exchanges the model delta once (the compressing kinds);
``--ef-dtype bfloat16`` keeps the EF memory in bf16.

``--downlink compressed`` re-compresses the aggregate through the same
wire format with the server's EF memory (``comm/downlink.py``) at
``--downlink-gamma`` (0: the uplink's gamma) under
``--downlink-gamma-schedule`` ``fixed`` or ``linear``; the log line adds
``down=``, the downlink's effective bytes.

``--transport overlap`` ships the bucketed payload over a chunked ring
of ``--overlap-chunks`` sections; at ``--overlap-delay 1`` (the
default) each step ships and applies the previous step's payload, its
collectives posted before the step's gradient (``comm/overlap.py``),
and at 0 it equals ``bucketed`` bit for bit.  The log line adds
``stale=``, the ``staleness`` metric: 1 when the applied aggregate is
one step old, 0 on the warm-up step (a zero update) and at delay 0.

``--transport gossip --topology {ring,torus,exp}`` sends the bucketed
payload to the graph's neighbours only (``comm/gossip.py``); each rank
keeps its own model, mixes itself with its neighbours and steps the
consensus correction by the AdaGossip rate (``--consensus-lr``,
``--consensus-beta``, ``--consensus-lr-max``).  At one worker it posts
no P2P operation and equals ``bucketed``.

Hostile wire (DESIGN.md §16): ``--fault-bitflip``, ``--fault-count``,
``--fault-nonfinite`` and ``--fault-zero-row`` set per-row rates of a
seeded fault campaign (``--fault-seed``, ``--fault-worker``, a burst of
``--fault-steps`` rounds from ``--fault-start-step``) that corrupts the
gathered payload rows before decode, through the ``faulty`` wrapper
around the chosen transport (``comm/faults.py``).  Every decode runs the
verdicts and quarantines invalid rows by default; ``--no-quarantine``
turns them off for a campaign, leaving the breaker as the only defense.
The log line adds ``skips=`` and ``quar=`` once either is nonzero.

The federated cohort (DESIGN.md §13): ``--n-clients N`` runs N
simulated clients, ``N / W`` on each worker, each with its own EF
memory, gamma controller and Armijo step; client c draws its rows from
shard c of the ``(--fed-seed, step, shard)`` stream, tilted per client
by ``--dirichlet-alpha`` (non-IID), and each round samples its
participants on the host (``--client-sampling fixed
--clients-per-round K``, or ``bernoulli --participation-rate p``, then
``--straggler-rate``).  ``--aggregation support`` divides each
coordinate by the participants that sent it, ``mean`` by all of them.
The log line adds ``part=``, the round's participants.

Checkpoints: ``--ckpt-dir D`` saves ``{"params", "state"}`` after every
``--ckpt-every`` completed steps and at the end, under
``D/rank_<r:03d>/step_<n:010d>`` (``checkpoint/checkpoint.py``), where
n counts completed steps; ``--resume`` restores the newest step every
rank has committed and runs steps n ... ``--steps`` - 1, so a resumed
run equals an uninterrupted one.  (The JAX CLI labels the state
after step s as s and so replays batch s on resume.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.comm.exchange import init_process_group
from repro_torch.comm.faults import FaultConfig
from repro_torch.comm.gossip import GossipConfig
from repro_torch.comm.overlap import OverlapConfig
from repro_torch.comm.topology import TOPOLOGIES
from repro_torch.comm.transport import transport_names
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import EF_DTYPES, KINDS, FederatedConfig, \
    OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import SCHEDULES, GammaControllerConfig
from repro_torch.core.health import check_divergence
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.fed.sampling import participation_mask
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train_step import init_train_state, train_step
from repro_torch.models import build_model

logger = logging.getLogger(__name__)


def cut_depth(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` layers, its widths unchanged; raises for an
    encoder-decoder (``n_layers`` is not its depth) and, through the
    config's own check, for a vlm depth that is not a whole number of
    groups."""
    if cfg.family == "encdec":
        raise ValueError(f"n_layers={n_layers}: {cfg.name} is an "
                         "encoder-decoder, whose depth is n_enc_layers and "
                         "n_dec_layers; cutting n_layers would cut nothing")
    return dataclasses.replace(cfg, n_layers=n_layers)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-100m",
                    choices=["paper-lm-100m", "granite-moe-1b-a400m",
                             "zamba2-7b", "seamless-m4t-large-v2",
                             "llama-3.2-vision-11b"])
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
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="acgd: Nesterov mu (arXiv 2002.11364); heavy-ball "
                         "momentum for single-node CSGD lives in "
                         "repro_torch.core.csgd")
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
                         "reference; the ragged kernels when adaptive); "
                         "gossip = serverless neighbor P2P consensus "
                         "exchange (DESIGN.md §12); overlap = "
                         "chunked-ring, double-buffered exchange "
                         "(DESIGN.md §14)")
    # ---- overlapped exchange (transport=overlap, DESIGN.md §14) ----
    ap.add_argument("--overlap-chunks", type=int,
                    default=OverlapConfig.n_chunks,
                    help="ring chunk count: the payload crosses each link "
                         "as n_chunks independent point-to-point hops per "
                         "ring step")
    ap.add_argument("--overlap-delay", type=int,
                    default=OverlapConfig.delay, choices=[0, 1],
                    help="1 = double-buffered: ship the PREVIOUS step's "
                         "payload so the collective overlaps this step's "
                         "compute; 0 = synchronous (bit-exact vs bucketed)")
    # ---- gossip / consensus (transport=gossip, DESIGN.md §12) ----
    ap.add_argument("--topology", default=GossipConfig.topology,
                    choices=sorted(TOPOLOGIES),
                    help="gossip mixing graph over the dp workers")
    ap.add_argument("--consensus-lr", type=float,
                    default=GossipConfig.consensus_lr,
                    help="numerator of the AdaGossip adaptive consensus "
                         "step (capped at --consensus-lr-max)")
    ap.add_argument("--consensus-beta", type=float,
                    default=GossipConfig.beta,
                    help="EMA decay of the gossip-error second moment")
    ap.add_argument("--consensus-lr-max", type=float,
                    default=GossipConfig.lr_max,
                    help="consensus step cap (the fixed-step baseline)")
    # ---- hostile-wire robustness (DESIGN.md §16) ----
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the (seed, step, worker)-deterministic "
                         "fault-injection stream")
    ap.add_argument("--fault-bitflip", type=float, default=0.0,
                    help="per-row probability of flipping one random wire "
                         "bit in the gathered payload")
    ap.add_argument("--fault-count", type=float, default=0.0,
                    help="per-row probability of a truncated/overflowed "
                         "ragged count header")
    ap.add_argument("--fault-nonfinite", type=float, default=0.0,
                    help="per-row probability of a NaN/Inf scale or value "
                         "field")
    ap.add_argument("--fault-zero-row", type=float, default=0.0,
                    help="per-row probability of zeroing the whole row "
                         "(dropped-worker model: decodes as a VALID empty "
                         "contribution)")
    ap.add_argument("--fault-worker", type=int, default=-1,
                    help="gathered row-slot to target (-1 = all workers)")
    ap.add_argument("--fault-start-step", type=int, default=0,
                    help="first step of the fault burst")
    ap.add_argument("--fault-steps", type=int, default=-1,
                    help="burst length in steps (-1 = open-ended)")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="disable the defensive decode verdicts (corrupt "
                         "rows flow into the mean; the step-level breaker "
                         "is the only remaining defense)")
    ap.add_argument("--max-consecutive-skips", type=int,
                    default=OptimizerConfig.max_consecutive_skips,
                    help="step-level circuit breaker: this many consecutive "
                         "non-finite (skipped) rounds raise "
                         "DivergenceError naming the last good step "
                         "(0 disables the gate)")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="local Armijo-SGD steps per exchange round "
                         "(csgd_asss | nonadaptive; needs --microbatches "
                         "equal to it)")
    ap.add_argument("--ef-dtype", default="float32",
                    help=f"EF memory dtype, one of {EF_DTYPES} (int8 "
                         "raises: see OptimizerConfig)")
    # ---- compressed downlink (DESIGN.md §15) ----
    ap.add_argument("--downlink", default="dense",
                    choices=["dense", "compressed"],
                    help="return direction of the aggregate: 'dense' ships "
                         "the full f32 mean (bit-exact reference); "
                         "'compressed' re-compresses it through the same "
                         "wire format with server-side error feedback — "
                         "no extra collective")
    ap.add_argument("--downlink-gamma", type=float, default=0.0,
                    help="downlink compression level (0 = the uplink "
                         "compressor's gamma)")
    ap.add_argument("--downlink-gamma-schedule", default="fixed",
                    choices=["fixed", "linear"],
                    help="open-loop downlink gamma schedule (the simulated "
                         "server has no telemetry to couple to)")
    # ---- federated cohort simulation (DESIGN.md §13) ----
    ap.add_argument("--n-clients", type=int, default=0,
                    help="> 0: federated cohort simulation — vmap "
                         "n-clients/W simulated clients per dp worker, "
                         "each with its own non-IID shard, EF memory and "
                         "gamma controller")
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="fixed-size sampling: participants per round "
                         "(0 = all clients)")
    ap.add_argument("--client-sampling", default="fixed",
                    choices=["fixed", "bernoulli"],
                    help="per-round participation sampler (fed/sampling.py)")
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    help="bernoulli sampling: per-client participation "
                         "probability")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="probability a sampled client drops out "
                         "(straggler model, applied after sampling)")
    ap.add_argument("--aggregation", default="support",
                    choices=["support", "mean"],
                    help="cohort aggregation: 'support' divides each "
                         "coordinate by its nonzero-support count; 'mean' "
                         "is the zero-averaging dense-pmean reference")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.0,
                    help="> 0: non-IID client shards via per-client "
                         "Dirichlet(alpha) unigram tilt (data/synthetic.py)")
    ap.add_argument("--fed-seed", type=int, default=0,
                    help="seed for participation sampling + client shards")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON metrics log")
    return ap.parse_args(argv)


def _min_max_over_ranks(x: int, device) -> tuple[int, int]:
    """(min, max) of an int over the process group, in one all-reduce."""
    t = torch.tensor([-x, x], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return -int(t[0]), int(t[1])


def rank_dir(ckpt_dir: str, rank: int) -> str:
    return os.path.join(ckpt_dir, f"rank_{rank:03d}")


def resume(ckpt_dir: str, tree_like, device):
    """Restore this rank's part of the newest step every rank has
    committed: ``(tree, metadata)``, or None when no rank has a
    checkpoint.  A step whose files are corrupt on some rank is skipped
    by all ranks together (a warning names it) for the next older
    common one, as ``checkpoint.restore`` falls back; a skeleton
    mismatch raises on every rank.  Raises ``ValueError`` when the
    checkpoints were saved by another number of workers."""
    W, rank = dist.get_world_size(), dist.get_rank()
    saved = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("rank_")) if os.path.isdir(ckpt_dir) \
        else []
    if saved and saved != [f"rank_{r:03d}" for r in range(W)]:
        raise ValueError(f"--resume: {ckpt_dir} holds checkpoints of "
                         f"{len(saved)} workers ({saved}), this run has {W}")
    mine = ckpt.all_steps(rank_dir(ckpt_dir, rank))
    lo, hi = _min_max_over_ranks(mine[-1] if mine else -1, device)
    if hi < 0:
        return None
    while True:
        if lo < 0:
            raise FileNotFoundError(
                f"no step of {ckpt_dir} is committed and intact on all "
                f"{W} ranks")
        status, err = 1, None
        try:
            out = ckpt.restore(rank_dir(ckpt_dir, rank), tree_like, step=lo)
        except AssertionError as e:
            status, err = -1, e
        except ckpt.CORRUPTION_ERRORS as e:
            status, err = 0, e
        worst = _min_max_over_ranks(status, device)[0]
        if worst == 1:
            return out
        if worst < 0:
            raise err if err is not None else AssertionError(
                f"another rank's checkpoint at step {lo} does not match "
                "its skeleton")
        logger.warning("checkpoint step_%010d of %s is not intact on every "
                       "rank (%s) — falling back to the next older common "
                       "step", lo, ckpt_dir, err)
        older = [s for s in mine if s < lo]
        lo = _min_max_over_ranks(older[-1] if older else -1, device)[0]


def main(argv=None) -> list[dict]:
    """Run the CLI; returns the logged metrics (one dict per logged step,
    with ``step`` and ``step_s``, the step's wall seconds)."""
    return run(argv)[0]


def run(argv=None, n_layers: int | None = None, **model_fields):
    """Run the CLI; returns ``(log, params, state)``: the logged metrics
    as :func:`main` returns them, and this worker's final parameters and
    ``TrainState``.  ``n_layers`` cuts the depth of ``--arch`` (the
    widths stay the config's), as ``serve.load`` does; an
    encoder-decoder, whose depth is its ``n_enc_layers`` and
    ``n_dec_layers``, refuses it.  ``model_fields`` replace fields of
    the model config that no flag reaches (``remat=False``), as JAX's
    dry-run replaces them."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    cfg = dataclasses.replace(cfg, **model_fields)
    run_cfg = RunConfig(
        model=cfg, shape=ShapeConfig(args.seq_len, args.global_batch),
        microbatches=args.microbatches,
        optimizer=OptimizerConfig(
            kind=args.opt, eta=args.eta, momentum=args.momentum,
            max_consecutive_skips=args.max_consecutive_skips,
            armijo=ArmijoConfig(theory_safe=args.theory_safe),
            compressor=Compressor(
                gamma=args.gamma, method=args.compress_method,
                value_bits=args.value_bits, max_gamma=args.max_gamma),
            gamma_controller=GammaControllerConfig(
                schedule=args.gamma_schedule, gamma_min=args.gamma_min,
                ramp_steps=args.gamma_ramp_steps, ef_target=args.ef_target,
                ef_band=args.ef_band),
            transport=args.transport,
            gossip=GossipConfig(topology=args.topology,
                                consensus_lr=args.consensus_lr,
                                beta=args.consensus_beta,
                                lr_max=args.consensus_lr_max),
            overlap=OverlapConfig(n_chunks=args.overlap_chunks,
                                  delay=args.overlap_delay),
            ef_dtype=args.ef_dtype,
            local_steps=args.local_steps, downlink=args.downlink,
            downlink_gamma=GammaControllerConfig(
                schedule=args.downlink_gamma_schedule,
                gamma0=args.downlink_gamma),
            faults=FaultConfig(seed=args.fault_seed,
                               p_bitflip=args.fault_bitflip,
                               p_count=args.fault_count,
                               p_nonfinite=args.fault_nonfinite,
                               p_zero_row=args.fault_zero_row,
                               worker=args.fault_worker,
                               start_step=args.fault_start_step,
                               n_steps=args.fault_steps,
                               quarantine=not args.no_quarantine),
            federated=FederatedConfig(
                n_clients=args.n_clients,
                clients_per_round=args.clients_per_round,
                sampling=args.client_sampling,
                participation_rate=args.participation_rate,
                straggler_rate=args.straggler_rate,
                aggregation=args.aggregation,
                dirichlet_alpha=args.dirichlet_alpha,
                seed=args.fed_seed)))

    created = init_process_group(device)
    try:
        W, rank = dist.get_world_size(), dist.get_rank()
        B = run_cfg.shape.global_batch
        fed = run_cfg.optimizer.federated
        if fed.enabled and B % fed.n_clients:
            raise SystemExit(
                f"--global-batch {B} must divide evenly across "
                f"--n-clients {fed.n_clients}")
        if not fed.enabled and B % W:
            raise SystemExit(f"--global-batch {B} does not split over {W} "
                             "workers")
        params = build_model(cfg).init(0, device=device)
        state = init_train_state(params, run_cfg, W)
        start = 0
        if args.resume and args.ckpt_dir:
            got = resume(args.ckpt_dir, {"params": params, "state": state},
                         device)
            if got is not None:
                tree, meta = got
                params, state = tree["params"], tree["state"]
                start = meta["step"]
                if state.step != start or meta["world_size"] != W:
                    raise ValueError(f"checkpoint metadata {meta} does not "
                                     f"match its state (step {state.step}, "
                                     f"{W} workers)")
                if rank == 0:
                    print(f"resumed from step {start}", flush=True)
        make_batch = batch_source(run_cfg, W, rank, device)
        log = []
        saved = None
        for step in range(start, args.steps):
            batch = make_batch(step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            params, state, m = train_step(params, state, batch, run_cfg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            m["step"] = step
            m["step_s"] = time.perf_counter() - t0
            # host-side breaker, as the JAX trainer's loop runs it
            check_divergence(m, run_cfg.optimizer.max_consecutive_skips)
            if step % args.log_every == 0 or step == args.steps - 1:
                log.append(m)
                if rank == 0:
                    down = (f"down={m['downlink_effective_wire_bytes']:.3e}B "
                            if "downlink_effective_wire_bytes" in m else "")
                    stale = (f"stale={m['staleness']:.0f} "
                             if "staleness" in m else "")
                    part = (f"part={m['participants']:.0f} "
                            if "participants" in m else "")
                    print(f"step {step:5d} loss={m['loss']:.4f} "
                          f"alpha={m['alpha']:.4g} evals={m['n_evals']:.2f} "
                          f"up={m['wire_bytes']:.3e}B "
                          f"eff={m['effective_wire_bytes']:.3e}B "
                          f"{down}{stale}{part}"
                          f"cum={m['cum_effective_wire_bytes']:.3e}B "
                          f"gamma={m['gamma']:.4g} "
                          f"backlog={m['ef_backlog']:.3g} "
                          f"cos={m['ef_cosine']:.3f} "
                          f"step_s={m['step_s']:.3f}"
                          + (f" skips={m['steps_skipped']:.0f}"
                             f" quar={m['rows_quarantined']:.0f}"
                             if m["steps_skipped"] or m["rows_quarantined"]
                             else ""), flush=True)
            # labelled by completed steps: a resume runs the next batch
            if args.ckpt_dir and args.ckpt_every > 0 \
                    and state.step % args.ckpt_every == 0:
                saved = _save(args.ckpt_dir, rank, W, params, state)
        if args.ckpt_dir and saved != state.step:
            _save(args.ckpt_dir, rank, W, params, state)
        if args.out and rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(log, f, indent=1)
        return log, params, state
    finally:
        if created:
            dist.destroy_process_group()


def batch_source(run_cfg, W: int, rank: int, device):
    """``step -> batch`` of this rank: its rows of the global batch (every
    key: ``tokens`` and, for an encoder-decoder, ``src_embed``, for a
    vlm ``image_embed``, JAX's ``batch_with_aux``); in a cohort its C =
    n_clients / W clients' rows, each key stacked to (C, rows, ...)
    from clients ``rank*C ... rank*C + C - 1`` (client c is shard c of the ``(fed.seed, step,
    shard)`` stream, Dirichlet-tilted), and the round's whole
    (n_clients,) participation mask, built on the host as JAX's trainer
    builds it."""
    cfg, B = run_cfg.model, run_cfg.shape.global_batch
    fed = run_cfg.optimizer.federated
    if not fed.enabled:
        pipe = TokenPipeline(vocab_size=cfg.vocab_size,
                             seq_len=run_cfg.shape.seq_len, global_batch=B)
        rows = slice(rank * B // W, (rank + 1) * B // W)
        return lambda step: {k: v[rows].to(device) for k, v in
                             pipe.batch_with_aux(step, cfg).items()}
    C = fed.n_clients // W
    pipes = [TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=run_cfg.shape.seq_len,
        global_batch=B, seed=fed.seed, n_shards=fed.n_clients, shard=c,
        dirichlet_alpha=fed.dirichlet_alpha)
        for c in range(rank * C, rank * C + C)]

    def make(step):
        rows = [p.batch_with_aux(step, cfg) for p in pipes]
        return {**{k: torch.stack([r[k] for r in rows]).to(device)
                   for k in rows[0]},
                "participation": participation_mask(
                    fed.n_clients, step, seed=fed.seed, mode=fed.sampling,
                    clients_per_round=fed.clients_per_round,
                    rate=fed.participation_rate,
                    straggler_rate=fed.straggler_rate)}
    return make


def _save(ckpt_dir: str, rank: int, W: int, params, state) -> int:
    ckpt.save(rank_dir(ckpt_dir, rank), state.step,
              {"params": params, "state": state},
              metadata={"step": state.step, "world_size": W})
    return state.step


if __name__ == "__main__":
    main()
