#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches and continues):

1. print the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a``, one compiler per source, all started together;
3. hold each of the 10 kernels against its plain PyTorch version on the
   card and time both with CUDA events (median of 25 runs) beside the
   kernel's bound (bytes at the H100's 3.35 TB/s or operations at its
   peak for their type): the 7 training kernels at the shapes
   paper-lm-100m's two training paths give them (bit-exact; the pass-1
   moments within 8 ulp), plus a block of rows with NaN, +-inf, zeros
   and ties through every pass-1 kernel at k_b 1, 10, 41, 102 and 1024,
   ``ef_block_stats`` through its only path,
   ``ops.fused_ef_compress(telemetry=False)``, with the launch counts set
   to 0 just before and read just after; ``block_stats`` also checked
   and timed at the largest CSGD leaf at k_b 10, 41 and 102 (gamma 1%,
   4%, 10%) beside ``torch.topk`` (timed only), host launch included and
   on the device alone; both EF pass-1 kernels checked (tau bit-exact,
   moments within 8 ulp) and timed the same two ways at the trainer's
   rows at k_b 10, 41 and 102; the codec kernels ``pack_words`` and
   ``unpack_words`` bit-exact at the trainer's 16-bit index streams at
   gamma 1%, 4% and 10% and its 8-bit value stream at 1%, each timed
   host launch included, on the device alone (and with L2 evicted) and
   by the host's time a call, beside the narrowing casts that compute
   the same function (timed only), and bit-exact at 4 bits, ragged
   rows, an input base one word or field off 16 bytes and lengths no
   multiple of 4 words; the ragged variants ``pack_words_ragged`` and
   ``unpack_words_ragged`` bit-exact at every section of the perleaf
   trainer's rows at k_b_t 41, 72 and 102 (and counts that differ per
   row), timed at its largest, the embedding row's 16-bit index section
   (626,688 words), at k_b_t 41; ptxas spills in ``ef_topk.cu`` and
   ``wire_pack.cu`` are fatal; the 3 serving
   kernels at the shapes serving gives them (flash attention's bf16
   tensor-core route at qwen1.5-4b's prefill, (4, 20, 2048, 128) causal,
   and at 20 edge cases that cross every tile edge, through strided
   (B, S, H, D) views, within 1 bf16 ulp of the plain value plus 1e-5,
   with its ptxas line (registers, shared memory, spills: none allowed);
   its f32 CUDA-core route at small cases with a window, without
   causality, with Sq < Sk and at D 32, atol 3e-5, and timed at the qwen
   shape on an earlier line; RMSNorm at (8192, 2560),
   (4, 2560) and (4096, 2048) bf16 within 1 bf16 ulp and (4096, 2048) f32
   within 1e-5, its ptxas spills none; WKV at (4, 1024, 32, 64) and at
   S = 1 within 2e-5, timed at both, its ptxas spills none),
   beside the library calls ``F.scaled_dot_product_attention`` and
   ``F.rms_norm`` (timed only; the port never calls them);
4. run the DCSGD-ASSS trainer (``repro_torch.launch.train``) on
   paper-lm-100m at full width — 12 layers, d_model 768, vocab 16384,
   seq 256, global batch 8, ``--compress-method block_topk`` — for 4
   steps, with every launch count set to 0 just before and read just
   after, then 2 steps at ``--value-bits 8`` and 2 at ``--gamma 0.1``
   (k_b 102, the paper's 10%) the same way;
4b. profile one warm trainer step at gamma 0.01 and one at gamma 0.1:
   device time by kernel group, the device's idle share and the host
   time of each train_step span;
4c. run single-node CSGD-ASSS (``repro_torch.core.csgd.csgd_asss``,
   ``block_topk``, gamma 0.01) on the same model and batches for 4
   steps the same way: 11 ``block_stats`` and 11 ``threshold_split``
   launches per step, none of the other kernels, finite losses, the EF
   identity sent + residual == acc on the largest leaf, exact wire bytes;
   then profile one more step as in 4b;
4d. serve at full width through ``repro_torch.launch.serve --full``,
   random weights from seed 0, batch 4, 16 tokens each (a prefill and
   15 decode steps), with the counts set to 0 just before each run and
   read just after: qwen1.5-4b at ctx 2048 (40 flash-attention launches,
   all through the bf16 tensor-core kernel, and 81 x 16 = 1296 RMSNorm
   launches, no other kernel), then rwkv6-1.6b at
   ctx 1024 (24 x 16 = 384 WKV and 49 x 16 = 784 RMSNorm launches);
   finite logits; prefill seconds, decode ms per step, tokens per second
   and peak memory; then one profiled prefill and one profiled decode
   step of each, with device time under each kernel's own name and the
   idle share (fatal if a path's kernels are missing from its trace);
4e. the adaptive trainer at full width: ``--max-gamma 0.1 --gamma 0.04
   --gamma-schedule linear --gamma-ramp-steps 2 --value-bits 8``, so
   gamma_t runs 0.04, 0.07, 0.1, for 3 steps on ``--transport perleaf``
   (per step 9 ``ef_stats_telemetry``, 9 ``ef_apply`` and 18 launches of
   each ragged codec kernel, no other kernel) and 3 on ``bucketed`` (no
   ragged launch), each step's effective bytes 13,302,448 / 23,301,808 /
   32,978,608 and its static bytes 32,978,608; from one saved state, grads
   and batch one exchange through each transport, parameters and EF
   memory bit-identical; 2 steps of ``--gamma-schedule ef-coupled`` at
   32-bit values on perleaf, finite losses; one profiled perleaf step at
   gamma_t 0.04, as in 4b;
4f. the trainer's other optimizer kinds at full width, gamma 0.01,
   with the counts set to 0 just before each run and read just after:
   ``--opt nonadaptive --eta 0.1`` for 2 steps (phase 4's launches a
   step, 6,528,000 B a step, alpha 0.1, no Armijo trial), ``--opt sls``
   for 2 (no kernel launch, the dense 440,478,720 B a step, at least one
   trial a step), ``--opt sgd`` and ``--opt dense`` for 1 each (no
   launch, 440,478,720 B), ``--microbatches 2`` for 2 (phase 4's
   launches, finite losses); step times and peak memory; then ``--opt
   sgd --eta inf --max-consecutive-skips 2``, which must raise
   ``DivergenceError`` at step 1 with no good step before it; one
   profiled ``nonadaptive`` step and one at 2 microbatches, as in 4b;
4g. the trainer's runtime beyond one step at full width, gamma 0.01,
   the counts set to 0 just before each run and read just after:
   ``--local-steps 2 --microbatches 2`` for 2 rounds, as ``csgd_asss``
   and as ``nonadaptive`` (1 launch of each of the four training kernels
   a round, 6,528,000 B a round, at least one Armijo trial a round,
   finite losses; round times and peak memory); ``--ef-dtype bfloat16``
   for 2 steps (phase 4's launches; every EF memory leaf bf16 on the
   card, 220,239,360 B); checkpoints: 2 steps with ``--ckpt-dir``
   (under ``_smoke_ckpt/`` beside this script, deleted afterwards)
   ``--ckpt-every 1``, step 2 restored onto the card bit-identical to
   the parameters and EF memory the run ended with, the save and
   restore seconds and the bytes on disk, then ``--steps 4 --resume``,
   which must log steps 2 and 3; one profiled local-steps round, as in
   4b, with one ``train_step.local_step`` span a local step;
4h. ACGD and the compressed downlink at full width, gamma 0.01 unless
   said, the counts set to 0 just before each run and read just after:
   ``--opt acgd --eta 0.1 --momentum 0.9`` for 2 steps (1 launch of each
   of the four training kernels a step and no other, 6,528,000 B a step,
   alpha 0.1, no Armijo trial, every velocity leaf f32 on the card,
   440,478,720 B); ``--downlink compressed`` (``csgd_asss``) for 2
   (phase 4's launches, so the downlink launches none; 6,528,000 B up
   and down a step, static and effective; cum_effective_wire_bytes
   26,112,000 after 2 steps; the server memory 110,100,480 f32 words on
   the card); ``--opt acgd --downlink compressed --transport perleaf
   --max-gamma 0.1 --gamma 0.04 --downlink-gamma 0.04 --value-bits 8``
   for 2 (9 EF pairs and 18 launches of each ragged codec kernel a step,
   effective bytes 13,302,448 and static 32,978,608 each way);
   ``roundtrip_rows`` bit-identical to ``decode_rows(encode_rows)``
   through the CUDA codec at every compressed leaf's rows at 32 and 8
   bits and ragged at count 41 of 102; one profiled warm step of ``acgd
   --downlink compressed``, as in 4b, with the ``train_step.downlink``
   span, then the server round alone under the profiler (its sort and
   its other passes, no kernel of the port); single-node ACGD
   (``repro_torch.core.acgd.acgd``, ``block_topk``, eta 0.1, mu 0.9) on
   the model and batches of 4c for 3 steps, checked as 4c checks
   CSGD-ASSS, and one profiled step;
4i. the overlap transport at full width, gamma 0.01 unless said, the
   counts set to 0 just before each run and read just after (the
   ragged codec kernels must stay at 0 in every run):
   ``--transport overlap --overlap-delay 0 --overlap-chunks 4`` for 3
   steps at 32- and at 8-bit values against ``bucketed``, bit for bit
   (parameters, EF memory, wire and effective bytes, gamma_t) with
   bucketed's launches; at delay 1 (4 chunks) step 1 a zero update with
   bucketed step 1's EF memory and step 2 bucketed step 1's parameters,
   bit for bit, ``staleness`` 0 then 1, effective bytes the zero
   payload's then bucketed step 1's, launches bucketed's; ``--local-steps
   2 --microbatches 2`` and a 10% budget (``--max-gamma 0.1 --gamma
   0.04``) for 2 rounds each at delay 1, the adaptive run against
   bucketed's launches and its step-2 effective bytes against bucketed
   step 1's, and after each one exchange from its final state with
   decode(own payload) + m' == m + eta*g bit for bit on the embedding
   leaf; a delay-1 checkpoint after 2 steps restored on the card and
   resumed to 4, bit for bit with 4 straight steps; warm step times and
   peaks (above what earlier runs hold); one profiled delay-1 step,
   as in 4b, with its ``train_step.overlap_start`` span;
4j. the gossip transport at full width on one worker (ring(1): no edge,
   so no P2P operation), gamma 0.01, the counts set to 0 just before
   each run and read just after (the ragged codec kernels must stay at
   0): ``--transport gossip`` for 3 steps at 32- and at 8-bit values
   against ``bucketed`` from the same seed: EF memory bit for bit,
   parameters equal (``torch.equal``), wire and effective bytes and
   gamma_t equal, bucketed's launches, the GossipState at v 0 and lr 1
   after every step; a checkpoint after 2 steps resumed to 4, bit for
   bit with 4 straight steps; warm step times and peaks; one profiled
   warm gossip step beside a bucketed one, as in 4b: the gossip
   exchange span shows no collective and no NCCL kernel while
   bucketed's shows its all-gather and all-reduce (the metrics'
   all-reduce lies outside the span);
4k. the hostile wire (DESIGN.md §16) at full width on one worker, gamma
   0.01 unless said, the counts set to 0 just before each run and read
   just after: 3 steps each of bucketed at 32 and 8 bits and perleaf at
   a 10% budget (``--max-gamma 0.1 --gamma 0.04 --value-bits 8``) with
   the decode verdicts (the default) against ``guards_disabled()``, bit
   for bit with the same launches, and the exchange alone and a whole
   ``train_step`` from one state timed both ways in turns; a synthetic
   3-row gathered decode through ``_consume_decoded_leaf`` on the card,
   its guarded mean the true division by 3 and its unguarded one the
   product with f32(1/3), bit for bit; ``--fault-nonfinite 1.0 --fault-start-step 1
   --fault-steps 1``: step 0 the clean run's, step 1 quarantines every
   compressed row and keeps every compressed leaf's EF memory, finite
   parameters, no skip; ``--fault-bitflip 1.0 --fault-count 1.0`` on
   that perleaf run, guarded and with ``--no-quarantine``: no device
   assert, the clean run's launches, each corrupted row and its decode
   through the ragged CUDA codec equal to the CPU port's bit for bit, a
   row whose count reads -1 decoded to zeros; the faulty wrapper around
   overlap (delay 1) and gossip outside its burst, bit for bit with
   them; a checkpoint at step 2 of a 3-step burst, resumed to 4, bit for
   bit with 4 straight steps;
5. run the 2-layer smoke variants on the card and on the CPU (the plain
   versions, which the CPU tests hold against the JAX package), through
   the trainer for 2 steps (``--opt csgd_asss``, ``nonadaptive``,
   ``sls`` and ``acgd``, ``--local-steps 2 --microbatches 2``,
   ``--ef-dtype bfloat16``, ``--downlink compressed``, ``--transport
   overlap`` at delay 1 and 0, ``--transport gossip``,
   ``--fault-bitflip 0.1`` with equal quarantined rows, and on
   ``--transport perleaf --max-gamma 0.1``), through
   CSGD-ASSS for 3 and through serving
   (qwen1.5-4b and rwkv6-1.6b, ctx 96, 4 tokens), and compare: equal
   greedy tokens and logits within 1e-4 of max|logits| for serving;
6. print the kernels as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without that last line when there is no CUDA device or
when the repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM, dense bf16 tensor cores
MAIN_STEPS, VB8_STEPS, G10_STEPS, CSGD_STEPS = 4, 2, 2, 4
MAIN_ARGS = ["--arch", "paper-lm-100m", "--compress-method", "block_topk",
             "--seq-len", "256", "--global-batch", "8", "--log-every", "1"]
REPLACES = {
    "ef_stats_telemetry": "src/repro/kernels/ef_topk.py:206",
    "ef_apply": "src/repro/kernels/ef_topk.py:107",
    "ef_block_stats": "src/repro/kernels/ef_topk.py:188",
    "block_stats": "src/repro/kernels/ef_topk.py:146",
    "threshold_split": "src/repro/kernels/ef_topk.py:243",
    "pack_words": "src/repro/kernels/wire_pack.py:109",
    "unpack_words": "src/repro/kernels/wire_pack.py:154",
    # the ragged bodies' pallas_call, inside pack_words / unpack_words
    "pack_words_ragged": "src/repro/kernels/wire_pack.py:143",
    "unpack_words_ragged": "src/repro/kernels/wire_pack.py:183",
    "flash_attention": "src/repro/kernels/flash_attention.py:83",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:30",
    "wkv_forward": "src/repro/kernels/rwkv_wkv.py:58",
}
SOURCES = {
    "ef_stats_telemetry": "src/repro_torch/csrc/ef_topk.cu",
    "ef_apply": "src/repro_torch/csrc/ef_topk.cu",
    "ef_block_stats": "src/repro_torch/csrc/ef_topk.cu",
    "block_stats": "src/repro_torch/csrc/ef_topk.cu",
    "threshold_split": "src/repro_torch/csrc/ef_topk.cu",
    "pack_words": "src/repro_torch/csrc/wire_pack.cu",
    "unpack_words": "src/repro_torch/csrc/wire_pack.cu",
    "pack_words_ragged": "src/repro_torch/csrc/wire_pack.cu",
    "unpack_words_ragged": "src/repro_torch/csrc/wire_pack.cu",
    # the bf16 route, the one serving takes and the kernels line times;
    # f32 inputs take src/repro_torch/csrc/flash_attention.cu
    "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "wkv_forward": "src/repro_torch/csrc/rwkv_wkv.cu",
}
#: serving at full width: (arch, ctx, launches of one run of 16 tokens,
#: the ``__global__`` names its prefill's trace must show)
SERVE_RUNS = (("qwen1.5-4b", 2048, dict(flash_attention=40,
                                        rmsnorm=81 * 16),
               ("flash_attention_sm90_kernel", "rmsnorm_kernel")),
              ("rwkv6-1.6b", 1024, dict(wkv_forward=24 * 16,
                                        rmsnorm=49 * 16),
               ("wkv_forward_kernel", "rmsnorm_kernel")))
SERVE_BATCH, SERVE_GEN = 4, 16
#: phase 4e: a 10% budget, gamma_t ramping 0.04 -> 0.07 -> 0.1
ADAPTIVE_ARGS = ["--max-gamma", "0.1", "--gamma", "0.04",
                 "--gamma-ramp-steps", "2"]
ADAPTIVE_STEPS, EF_COUPLED_STEPS = 3, 2
#: one worker's exchange bytes a step at 8-bit values: static, and
#: effective at gamma_t 0.04, 0.07 and 0.1 (k_b_t 41, 72, 102 of 102)
ADAPTIVE_STATIC = 32_978_608
ADAPTIVE_EFFECTIVE = [13_302_448, 23_301_808, 32_978_608]
#: phase 4f: one worker's bytes a step at gamma 0.01 with 32-bit values
#: (the compressing kinds) and of the dense exchange, 4 B a parameter
COMPRESSED_BYTES, DENSE_BYTES = 6_528_000, 440_478_720
#: phase 4g: local-steps rounds, bf16 EF steps, and the EF memory of
#: paper-lm-100m in each dtype
LOCAL_ROUNDS, BF16_STEPS = 2, 2
EF_BYTES = {"float32": 440_478_720, "bfloat16": 220_239_360}
#: phase 4h: trainer steps of each acgd / downlink run, single-node ACGD
#: steps, and the server EF memory of paper-lm-100m (its compressed
#: leaves' entries, f32)
ACGD_STEPS, ACGD_SINGLE_STEPS, SERVER_WORDS = 2, 3, 110_100_480
#: phase 4i: steps of each delay-0 run, ring chunks, and the steps of the
#: local-steps and adaptive runs
OVERLAP_STEPS, OVERLAP_CHUNKS, OVERLAP_LOCAL = 3, 4, 2
#: phase 4j: steps of each gossip run beside bucketed
GOSSIP_STEPS = 3
#: phase 4k: steps of each guarded / unguarded run, and the reps of the
#: exchange timed alone each way
FAULT_STEPS, FAULT_REPS = 3, 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, evict: bool = False) -> float:
    """Device time of one call, from the profiler's kernel times over
    ``reps`` calls: without the host's time before each launch, which
    ``time_ms`` keeps (and a host-bound decode pays).  With ``evict`` a
    256 MB write before each call leaves none of its inputs in the 50 MB
    L2; the write's own kernels are not counted."""
    def profile(calls) -> dict:
        """Device microseconds by the profiler's key over ``reps`` calls."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                calls()
            torch.cuda.synchronize()
        return {e.key: getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()}

    flush, skip = (lambda: None), set()
    if evict:
        scratch = torch.empty(2**26, dtype=torch.int32, device="cuda")
        flush = scratch.bitwise_not_
        skip = {k for k, us in profile(flush).items() if us > 0}
    fn()
    torch.cuda.synchronize()
    return sum(us for k, us in profile(lambda: (flush(), fn())).items()
               if k not in skip) / reps / 1e3


def host_ms(fn, reps: int = 1000) -> float:
    """The host's time a call, from ``time.perf_counter`` over ``reps``
    back-to-back calls without a synchronize: the wrapper's checks,
    allocation and launch (the device's time where the device is the
    slower and the launch queue fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def max_ulp(a, b) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


#: the ``__global__`` names of the port's kernels, one per kernel
PORTED = ("ef_stats_telemetry_kernel", "ef_block_stats_kernel",
          "block_stats_kernel", "ef_apply_kernel", "threshold_split_kernel",
          "pack_words_kernel", "unpack_words_kernel",
          "flash_attention_kernel", "flash_attention_sm90_kernel",
          "rmsnorm_kernel", "wkv_forward_kernel")


def kernel_group(name: str) -> str:
    """A port kernel's own name, else a coarse group of library kernels.
    A port kernel's name must stand as a whole identifier in the
    profiler's key (``(anonymous namespace)::block_stats_kernel(...)``,
    or ``void (anonymous namespace)::rmsnorm_kernel<float, float>(...)``
    for a template), so ``block_stats_kernel`` never matches
    ``ef_block_stats_kernel``."""
    for kernel in PORTED:
        if re.search(rf"\b{kernel}\b", name):
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "sm90_xmma", "cublas",
                              "nvjet")):
        return "matmul"
    if "sort" in low or "radix" in low:
        return "sort"
    if "nccl" in low:
        return "nccl"
    return "other"


def profile_step(dev, cfg, comp, label="trainer", transport="bucketed",
                 kind="csgd_asss", microbatches=1, local_steps=1) -> None:
    """One warm full-width train step under torch.profiler: device time
    by kernel group and the device's idle share of the step (a
    local-steps round: one ``train_step.local_step`` span a local
    step)."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    microbatches=microbatches,
                    optimizer=OptimizerConfig(kind=kind, compressor=comp,
                                              transport=transport,
                                              local_steps=local_steps))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        for step in range(2):
            batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
            params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
        prof, wall_ms = profiled(
            dev, lambda: train_step(params, state, batch, run))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    spans = report_profile(label, prof, wall_ms,
                           ("ef_stats_telemetry_kernel", "ef_apply_kernel",
                            "pack_words_kernel", "unpack_words_kernel"))
    # no armijo span where the kind does not search; a local-steps round
    # has local_step spans in place of grad and armijo; the overlap
    # transport at delay 1 adds its overlap_start span
    want = 3 if local_steps > 1 or kind not in ("csgd_asss", "sls") else 4
    want += transport == "overlap"
    if len(spans) != want or min(spans.values()) <= 0:
        fail(f"the profiler saw {label} train_step spans {spans}, want "
             f"{want} timed")
    if local_steps > 1:
        n = sum(ev.count for ev in prof.key_averages()
                if ev.key == "train_step.local_step"
                and ev.device_type == torch.autograd.DeviceType.CPU)
        print(f"  {n} train_step.local_step spans", flush=True)
        if n != local_steps:
            fail(f"the profiler saw {n} local_step spans in the {label} "
                 f"round, want {local_steps}")


def profiled(dev, fn):
    """(profiler, wall ms) of one call of ``fn`` under torch.profiler."""
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def report_profile(label, prof, wall_ms, kernels_of_path) -> dict:
    """Print device time by kernel group, the device's idle share of the
    step and the host time of each ``train_step.*`` span; fail unless
    each of the path's kernels shows under its own name; return the
    spans."""
    groups, kernels, spans = {}, [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("train_step."):
            # the CPU range; on CUDA the profiler adds a device-side copy
            # of each range under the same name
            if ev.device_type == torch.autograd.DeviceType.CPU:
                spans[ev.key] = ev.cpu_time_total / 1e3
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us <= 0 or getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CPU:
            continue
        groups[kernel_group(ev.key)] = groups.get(kernel_group(ev.key),
                                                  0.0) + us / 1e3
        kernels.append((us / 1e3, ev.count, ev.key))
    busy = sum(groups.values())
    if busy <= 0:
        fail(f"the profiler saw no device time in the {label} step")
    missing = [k for k in kernels_of_path if k not in groups]
    if missing:
        fail(f"the profiler saw no {missing} in the {label} step")
    print(f"profile [{label}]: one step {wall_ms:.2f} ms wall (profiler "
          f"on), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}, {sum(n for _, n, _ in kernels)} "
          "device kernels and copies")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.3f} ms ({ms / busy:.3f} of device time)")
    # host time in each phase of train_step: launches plus any wait for
    # the device (the Armijo trials and the metrics read values back)
    for name, ms in spans.items():
        print(f"  host {name}: {ms:.3f} ms ({ms / wall_ms:.3f} of wall)")
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {ms:8.3f} ms x{n:<4d} {key[:90]}")
    return spans


def step_wire_bytes(shapes, stacked, comp) -> float:
    """The bytes one step must put on the wire: the packed payload words
    plus the f32 dense leaves."""
    from repro_torch.comm.bucket import build_bucket_plan
    plan = build_bucket_plan(shapes, stacked, comp)
    return float(plan.total_words * 4 + sum(
        ln.L * ln.d * 4 for ln in plan.leaves if ln.dense))


def special_rows(dev):
    """Block rows that decide the selection's edge cases: one NaN,
    several NaNs, +inf twice, -inf, all zeros, rounded ties, all equal."""
    x = np.random.default_rng(21).standard_normal((8, 1024)).astype(
        np.float32)
    x[1, 5] = np.nan
    x[2, [3, 700, 900]] = np.nan
    x[3, [10, 600]] = np.inf
    x[4, 11] = -np.inf
    x[5] = 0.0
    x[6] = np.round(x[6] * 2.0)
    x[7] = -1.5
    return torch.from_numpy(x).to(dev)


def same(a, b) -> bool:
    """Bit-for-bit equal values, NaN where the other has NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_dense_selection(dev, gen, leaf_rows, k_b, paper_ks,
                          report) -> None:
    """block_stats and threshold_split (the single-node compress_dense
    path) against their plain versions: at the largest flat leaf, at a
    padded 9-row leaf through the public ops, and on the edge-case rows
    (with ef_block_stats and ef_stats_telemetry too); block_stats timed
    at the largest leaf at each of the paper's k_b beside torch.topk, and
    summed over one step's leaves."""
    from repro_torch.kernels import ef_topk, ops, ref
    entries = ptxas_entries("ef_topk", [
        "ef_stats_telemetry_kernel", "ef_block_stats_kernel",
        "block_stats_kernel", "ef_apply_kernel", "threshold_split_kernel"])
    if len(entries) != 5 or any(spill for _, _, spill in entries):
        fail(f"csrc/ef_topk.cu: ptxas reported spills, or not 5 kernels: "
             f"{entries}")
    print("ptxas ef_topk: no spills; registers "
          + ", ".join(f"{e} {r}" for e, r, _ in entries), flush=True)
    big = max(leaf_rows)
    x = torch.randn((big, 1024), generator=gen, device=dev) * 1e-2
    tau = ef_topk.block_stats(x, k_b)
    rtau = ref.block_abs_topk_threshold(x, k_b)
    sent, res = ef_topk.threshold_split(x, tau)
    rsent, rres = ref.threshold_split(x, tau)
    torch.cuda.synchronize()
    if not same(tau, rtau):
        fail(f"block_stats differs from the plain version in "
             f"{int((tau != rtau).sum())} of {big} rows")
    if not (torch.equal(sent, rsent) and torch.equal(res, rres)):
        fail("threshold_split differs from the plain version")
    if not torch.equal(sent + res, x):
        fail("threshold_split breaks sent + residual == x")

    leaf = torch.randn(8 * 1024 + 508, generator=gen, device=dev)
    t9 = ops.block_topk_threshold(leaf, k_b).reshape(-1, 1)
    x9 = torch.nn.functional.pad(leaf, (0, 516)).reshape(9, 1024)
    s9, r9 = ops.threshold_split_blocks(leaf, t9)
    rs9, rr9 = ref.threshold_split(x9, t9)
    if not same(t9, ref.block_abs_topk_threshold(x9, k_b)) \
            or not torch.equal(s9, rs9.reshape(-1)[:leaf.numel()]) \
            or not torch.equal(r9, rr9.reshape(-1)[:leaf.numel()]):
        fail("the padded 9-row leaf differs from the plain versions")

    sp = special_rows(dev)
    zeros = torch.zeros_like(sp)
    eta = torch.tensor([0.5], device=dev)
    edge_ks = sorted({1, *paper_ks, 1024})
    for kb in edge_ks:
        pairs = {
            "block_stats": (ef_topk.block_stats(sp, kb),
                            ref.block_abs_topk_threshold(sp, kb)),
            "ef_block_stats": (ef_topk.ef_block_stats(zeros, sp, eta, kb),
                               ref.ef_block_stats(zeros, sp, eta, kb)),
            "ef_stats_telemetry": (
                ef_topk.ef_stats_telemetry(zeros, sp, eta, kb)[0],
                ref.ef_block_stats_telemetry(zeros, sp, eta, kb)[0])}
        for name, (got, want) in pairs.items():
            if not same(got, want) or not torch.isnan(got[1:3]).all():
                fail(f"{name} at k_b={kb} differs from the plain version "
                     f"on the NaN/inf/tie rows: {got.ravel().tolist()} vs "
                     f"{want.ravel().tolist()}")
        ts, tr = ef_topk.threshold_split(sp, pairs["block_stats"][0])
        rs, rr = ref.threshold_split(sp, pairs["block_stats"][0])
        if not (same(ts, rs) and same(tr, rr)):
            fail(f"threshold_split at k_b={kb} differs on the NaN/inf rows")
    _, mom = ef_topk.ef_stats_telemetry(zeros, sp, eta, k_b)
    _, rmom = ref.ef_block_stats_telemetry(zeros, sp, eta, k_b)
    fin = torch.isfinite(rmom).all(1)
    if not same(mom[~fin], rmom[~fin]) or max_ulp(
            mom[fin].cpu().numpy(), rmom[fin].cpu().numpy()) > 8:
        fail("ef_stats_telemetry moments differ on the NaN/inf rows")
    print(f"edge-case rows (NaN, +-inf, zeros, ties) at k_b {edge_ks}: "
          f"tau {ef_topk.block_stats(sp, k_b).ravel().tolist()}", flush=True)

    # the paper's 1%, 4% and 10% at the largest leaf: each k_b checked,
    # then timed beside torch.topk at the same k_b (timed only)
    for kb in paper_ks:
        t = ef_topk.block_stats(x, kb)
        if not same(t, ref.block_abs_topk_threshold(x, kb)):
            fail(f"block_stats at k_b={kb} differs from the plain version "
                 f"at the largest leaf")

        def topk(kb=kb):
            return torch.topk(x.abs(), kb, dim=1).values[:, -1:]
        print(f"block_stats ({big}, 1024) k_b={kb}: "
              f"{time_ms(lambda: ef_topk.block_stats(x, kb)):.4f} ms, device "
              f"only {device_ms(lambda: ef_topk.block_stats(x, kb)):.4f} ms; "
              f"torch.topk {time_ms(topk):.4f} ms, device only "
              f"{device_ms(topk):.4f} ms", flush=True)

    per_step = {"block_stats": 0.0, "block_stats device": 0.0,
                "threshold_split": 0.0}
    for r in sorted(set(leaf_rows)):
        xr, tr_ = x[:r], tau[:r]
        n = leaf_rows.count(r)
        per_step["block_stats"] += n * time_ms(
            lambda: ef_topk.block_stats(xr, k_b))
        per_step["block_stats device"] += n * device_ms(
            lambda: ef_topk.block_stats(xr, k_b))
        per_step["threshold_split"] += n * time_ms(
            lambda: ef_topk.threshold_split(xr, tr_))
    print(f"one CSGD step's {len(leaf_rows)} leaves ({sum(leaf_rows)} block "
          f"rows): block_stats {per_step['block_stats']:.4f} ms (device only "
          f"{per_step['block_stats device']:.4f} ms), "
          f"threshold_split {per_step['threshold_split']:.4f} ms summed "
          f"(bounds {sum(leaf_rows) * 1028 * 4 / HBM_BYTES_PER_S * 1e3:.4f}"
          f" and {sum(leaf_rows) * 1024 * 12 / HBM_BYTES_PER_S * 1e3:.4f} "
          "ms)", flush=True)
    report["block_stats"] = dict(
        max_abs_err=float((tau - rtau).abs().max()),
        ms=time_ms(lambda: ef_topk.block_stats(x, k_b)),
        plain_ms=time_ms(lambda: ref.block_abs_topk_threshold(x, k_b)),
        library_ms=time_ms(
            lambda: torch.topk(x.abs(), k_b, dim=1).values[:, -1:]),
        # the function's work, whatever the kernel: each |x| once
        bytes=big * 1024 * 4 + big * 4, ops=big * 1024,
        note=f"largest leaf, {big} block rows")
    report["threshold_split"] = dict(
        max_abs_err=max(float((sent - rsent).abs().max()),
                        float((res - rres).abs().max())),
        ms=time_ms(lambda: ef_topk.threshold_split(x, tau)),
        plain_ms=time_ms(lambda: ref.threshold_split(x, tau)),
        bytes=big * 1024 * 12 + big * 4, ops=big * 1024 * 3,
        note=f"largest leaf, {big} block rows")


#: bits -> the signed and unsigned integer types of a field's width
NARROW = {16: (torch.int16, torch.uint16), 8: (torch.int8, torch.uint8)}


def cast_pack(fields: torch.Tensor, bits: int) -> torch.Tensor:
    """pack_words at 16 or 8 bits as one PyTorch call, a yardstick timed
    beside the kernel and used nowhere in the port: the narrowing cast
    keeps each field's low bits, and a little-endian view puts field f at
    bits [f*bits, (f+1)*bits) of a word."""
    return fields.to(NARROW[bits][0]).view(torch.int32)


def cast_unpack(words: torch.Tensor, bits: int) -> torch.Tensor:
    """unpack_words at 16 or 8 bits as one PyTorch call (a yardstick)."""
    return words.view(NARROW[bits][1]).to(torch.int32)


def check_wire(dev, gen, shapes, stacked, report) -> None:
    """pack_words and unpack_words (``csrc/wire_pack.cu``) against their
    plain versions, bit-exact: at the trainer's 16-bit index streams at
    gamma 1%, 4% and 10% and its 8-bit value stream at 1%, in the (rows,
    512)-word layout ``ops.pack_fields_stream`` gives them, then at 4
    bits, ragged, with the input's base one word or one field off and at
    lengths that are no multiple of 4 words.  Each stream timed by the
    three clocks (the device time also with L2 evicted) beside the
    narrowing cast that computes the same function, itself checked
    against the plain version.  ptxas spills in wire_pack.cu are fatal."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.kernels import ref, wire_pack
    entries = ptxas_entries("wire_pack", ["pack_words_kernel",
                                          "unpack_words_kernel"])
    if len(entries) != 18 or any(spill for _, _, spill in entries):
        fail(f"csrc/wire_pack.cu: ptxas reported spills, or not 18 "
             f"kernels: {entries}")
    print("ptxas wire_pack: no spills; registers "
          + ", ".join(f"{e} {r}" for e, r, _ in entries), flush=True)

    def lanes(gamma, value_bits):
        plan = build_bucket_plan(shapes, stacked, Compressor(
            gamma=gamma, method="block_topk", value_bits=value_bits))
        return [ln for ln in plan.leaves if not ln.dense]
    streams = {f"index gamma {gm}": (sum(
        ln.L * ln.spec.index_words for ln in lanes(gm, 32)), 16)
        for gm in (0.01, 0.04, 0.1)}
    streams["value gamma 0.01 (8-bit)"] = (sum(
        ln.L * ln.spec.value_words for ln in lanes(0.01, 8)), 8)

    def randint(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    for label, (W, bits) in streams.items():
        F = 32 // bits
        R, C = wire_pack.stream_shape(W)
        fields = randint(R, C * F)
        words = wire_pack.pack_words(fields, bits)
        back = wire_pack.unpack_words(words, bits)
        rwords = ref.pack_fields(fields, bits)
        rback = ref.unpack_fields(words, bits)
        if not torch.equal(words, rwords):
            fail(f"pack_words differs from the plain version at the "
                 f"{label} stream, {W} words")
        if not torch.equal(back, rback):
            fail(f"unpack_words differs from the plain version at the "
                 f"{label} stream, {W} words")
        if not (torch.equal(cast_pack(fields, bits), rwords)
                and torch.equal(cast_unpack(words, bits), rback)):
            fail(f"the narrowing casts differ from the plain versions at "
                 f"the {label} stream")
        bound = W * 4 * (1 + F) / HBM_BYTES_PER_S * 1e3
        for name, kernel, plain, cast, x, err in (
                ("pack_words", wire_pack.pack_words, ref.pack_fields,
                 cast_pack, fields,
                 (words.long() - rwords.long()).abs().max()),
                ("unpack_words", wire_pack.unpack_words, ref.unpack_fields,
                 cast_unpack, words,
                 (back.long() - rback.long()).abs().max())):
            t = {who: (time_ms(fn), device_ms(fn), device_ms(fn, evict=True),
                       host_ms(fn))
                 for who, fn in (("kernel", lambda: kernel(x, bits)),
                                 ("cast", lambda: cast(x, bits)))}
            clocks = ("{:.4f} ms, device {:.4f} (L2 evicted {:.4f}), host "
                      "{:.4f}")
            print(f"wire {label}, {R * C} words of {bits}-bit fields "
                  f"({W * 4 * (1 + F)} B, bound {bound:.4f} ms): {name} "
                  + clocks.format(*t["kernel"]) + f"; {cast.__name__} "
                  + clocks.format(*t["cast"]), flush=True)
            if label == "index gamma 0.01":
                report[name] = dict(
                    max_abs_err=float(err), ms=t["kernel"][0],
                    plain_ms=time_ms(lambda: plain(x, bits)),
                    library_ms=t["cast"][0],
                    bytes=W * 4 * (1 + F), ops=W * F * 3,
                    note=f"16-bit index stream {W} words; device "
                         f"{t['kernel'][1]:.4f} ms, cast {t['cast'][1]:.4f}")
        del fields, words, back, rwords, rback

    # the edges: 4 bits, ragged rows, an input base one word (or, for
    # pack, one field) off 16 bytes, lengths no multiple of 4 words
    cases = [(bits, rows, cols, period, 0) for bits in (4, 8, 16)
             for rows, cols, period in ((97, 40, 0), (97, 40, 11),
                                        (9, 40, 29))]
    cases += [(bits, 5, 203, 0, off) for bits in (4, 8, 16)
              for off in (0, 1)] + [(16, 1, 3, 0, 0), (8, 3, 1, 0, 1)]
    for bits, rows, cols, period, off in cases:
        F = 32 // bits
        cnt = torch.randint(0, period + 1, (rows,), generator=gen,
                            device=dev, dtype=torch.int32) \
            if period else None
        views = {"pack_words": randint(F + rows * cols * F)[
                     off * F:][:rows * cols * F].view(rows, cols * F),
                 "pack_words (one field off)": randint(1 + rows * cols * F)[
                     off:][:rows * cols * F].view(rows, cols * F),
                 "unpack_words": randint(1 + rows * cols)[off:][
                     :rows * cols].view(rows, cols)}
        for name, x in views.items():
            if name.startswith("pack"):
                got = wire_pack.pack_words(x, bits, cnt, period)
                want = ref.pack_fields(x, bits, cnt, period)
            else:
                got = wire_pack.unpack_words(x, bits, cnt, period)
                want = ref.unpack_fields(x, bits, cnt, period)
            if not torch.equal(got, want):
                fail(f"{name} differs from the plain version at bits={bits}"
                     f" ({rows}, {cols}) words, period {period}, base "
                     f"offset {off}")
    print(f"wire edges: bit-exact at {len(cases)} cases (4/8/16 bits, "
          "ragged at period 11 and 29, input base one word or field off, "
          "lengths 1015, 3 and 3 words)", flush=True)


def check_ragged_wire(dev, gen, shapes, stacked, report) -> None:
    """The ragged variants of the codec kernels against their plain
    versions, bit-exact, at every field section of the perleaf trainer's
    rows (16-bit index, 8-bit value) at k_b_t 41, 72 and 102 and at
    counts that differ per row; then timed at the largest section, the
    (16384, 768) embedding row's 16-bit index section at k_b_t 41."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.kernels import ref, wire_pack
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    lanes = [ln for ln in build_bucket_plan(shapes, stacked, comp).leaves
             if not ln.dense]
    cases = 0
    for ln in lanes:
        spec = ln.spec
        for bits, words in ((spec.index_bits, spec.index_words),
                            (spec.value_bits, spec.value_words)):
            F = 32 // bits
            fields = torch.randint(-2**31, 2**31 - 1, (ln.L, words * F),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            for c in (41, 72, 102, None):
                cnt = (torch.full((ln.L,), c, dtype=torch.int32, device=dev)
                       if c is not None else torch.randint(
                           0, spec.k_b + 1, (ln.L,), generator=gen,
                           device=dev, dtype=torch.int32))
                w = wire_pack.pack_words_ragged(fields, bits, cnt, spec.k_b)
                back = wire_pack.unpack_words_ragged(w, bits, cnt, spec.k_b)
                if not (torch.equal(w, ref.pack_fields(fields, bits, cnt,
                                                       spec.k_b))
                        and torch.equal(back, ref.unpack_fields(
                            w, bits, cnt, spec.k_b))):
                    fail(f"the ragged codec differs from the plain version "
                         f"at a ({ln.L}, {words})-word {bits}-bit section, "
                         f"count {c}")
                cases += 1
    print(f"ragged wire: bit-exact at {cases} cases ({len(lanes)} leaves, "
          "index and value sections, k_b_t 41 / 72 / 102 and random)",
          flush=True)

    big = max(lanes, key=lambda ln: ln.spec.index_words)
    spec, W = big.spec, big.spec.index_words
    F = 32 // spec.index_bits
    fields = torch.randint(-2**31, 2**31 - 1, (big.L, W * F), generator=gen,
                           device=dev, dtype=torch.int32)
    cnt = torch.full((big.L,), 41, dtype=torch.int32, device=dev)
    words = wire_pack.pack_words_ragged(fields, spec.index_bits, cnt,
                                        spec.k_b)
    rwords = ref.pack_fields(fields, spec.index_bits, cnt, spec.k_b)
    back = wire_pack.unpack_words_ragged(words, spec.index_bits, cnt,
                                         spec.k_b)
    rback = ref.unpack_fields(words, spec.index_bits, cnt, spec.k_b)
    # the function's work at this count: the valid fields and the words
    # that hold one (each read once), the other side written whole
    valid = (torch.arange(W * F, device=dev) % spec.k_b < 41)
    n_valid = int(valid.sum()) * big.L
    live_words = int(valid.view(W, F).any(-1).sum()) * big.L
    for name, kernel, plain, x, got, want, nbytes in (
            ("pack_words_ragged", wire_pack.pack_words_ragged,
             ref.pack_fields, fields, words, rwords,
             n_valid * 4 + W * big.L * 4 + big.L * 4),
            ("unpack_words_ragged", wire_pack.unpack_words_ragged,
             ref.unpack_fields, words, back, rback,
             live_words * 4 + W * F * big.L * 4 + big.L * 4)):
        def call(kernel=kernel, x=x):
            return kernel(x, spec.index_bits, cnt, spec.k_b)
        report[name] = dict(
            max_abs_err=float((got.long() - want.long()).abs().max()),
            ms=time_ms(call),
            plain_ms=time_ms(lambda plain=plain, x=x: plain(
                x, spec.index_bits, cnt, spec.k_b)),
            library_ms=None, bytes=nbytes, ops=W * F * big.L * 3,
            note=f"embedding row's 16-bit index section, {W} words, "
                 f"k_b_t 41 of {spec.k_b}; device {device_ms(call):.4f} ms")
        print(f"{name} ({big.L}, {W}) words, 16-bit, k_b_t 41: "
              f"{report[name]['ms']:.4f} ms, device only "
              f"{device_ms(call):.4f} ms (L2 evicted "
              f"{device_ms(call, evict=True):.4f}), host "
              f"{host_ms(call):.4f} ms; plain {report[name]['plain_ms']:.4f}"
              " ms", flush=True)


def adaptive_trainer(dev, shapes, stacked) -> dict:
    """Phase 4e: the adaptive trainer at full width through
    ``launch.train``, on each transport; returns the perleaf run's launch
    counts."""
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import plan_wire_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    plans = {bits: build_bucket_plan(shapes, stacked, Compressor(
        gamma=0.04, method="block_topk", max_gamma=0.1, value_bits=bits))
        for bits in (8, 32)}
    n = len(plans[8].compressed_ids)
    runs = {}
    for label, transport, bits, schedule, steps, per_step in (
            ("perleaf", "perleaf", 8, "linear", ADAPTIVE_STEPS,
             dict(ef_stats_telemetry=n, ef_apply=n, pack_words_ragged=2 * n,
                  unpack_words_ragged=2 * n)),
            ("bucketed", "bucketed", 8, "linear", ADAPTIVE_STEPS,
             dict(ef_stats_telemetry=1, ef_apply=1, pack_words=2,
                  unpack_words=2)),
            ("perleaf ef-coupled", "perleaf", 32, "ef-coupled",
             EF_COUPLED_STEPS,
             dict(ef_stats_telemetry=n, ef_apply=n, pack_words_ragged=n,
                  unpack_words_ragged=n))):
        comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                          value_bits=bits)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(MAIN_ARGS + ADAPTIVE_ARGS + [
            "--transport", transport, "--value-bits", str(bits),
            "--gamma-schedule", schedule, "--steps", str(steps)])
        counts = ops.launch_counts()
        runs[label] = counts
        peak = torch.cuda.max_memory_allocated(dev)
        gammas = [x["gamma"] for x in log]
        eff = [x["effective_wire_bytes"] for x in log]
        print(f"adaptive [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; gamma_t {gammas}; "
              f"wire bytes {[x['wire_bytes'] for x in log]}, effective "
              f"{eff}; losses {[x['loss'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * steps:
                fail(f"[adaptive {label}] {name} launched {c} times in "
                     f"{steps} steps, want {per_step.get(name, 0) * steps}")
        if not all(np.isfinite(x["loss"]) for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[adaptive {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        # the exchange's bytes from shapes at each step's gamma_t
        want = [plan_wire_bytes(plans[bits], comp, np.float32(gm))
                for gm in gammas]
        if [(x["wire_bytes"], x["effective_wire_bytes"]) for x in log] \
                != [(float(w), float(e)) for w, e in want]:
            fail(f"[adaptive {label}] bytes {eff} differ from the "
                 f"exchange's accounting {want}")
        if bits == 8 and (eff != ADAPTIVE_EFFECTIVE or any(
                x["wire_bytes"] != ADAPTIVE_STATIC for x in log)):
            fail(f"[adaptive {label}] effective bytes {eff}, want "
                 f"{ADAPTIVE_EFFECTIVE}; static "
                 f"{[x['wire_bytes'] for x in log]}, want {ADAPTIVE_STATIC}")
    return runs["perleaf"]


def transports_agree(dev, cfg) -> None:
    """Phase 4e: from one saved state (a warm EF memory), one batch and
    its grads, one exchange and update through each transport on the
    card at gamma_t 0.07: parameters and EF memory bit-identical.  The
    grads are computed once: the embedding's backward sums with atomics,
    so two backward passes may differ in the last bit."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.core.gamma import GammaControllerConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves, tree_map, value_and_grad
    comp = Compressor(gamma=0.04, method="block_topk", max_gamma=0.1,
                      value_bits=8)
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(
                        compressor=comp, gamma_controller=
                        GammaControllerConfig(schedule="linear",
                                              ramp_steps=2)))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(0).items()}
        params, state, _ = train_step(params, init_train_state(params, run),
                                      batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(1).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        gamma_t = np.float32(0.07)
        eta = run.optimizer.armijo.scale_for(gamma_t) * state.alpha_prev
        out = {}
        for tp in ("perleaf", "bucketed"):
            upd, mem, wire, eff, _ = worker_compress_aggregate(
                grads, state.memory, eta, comp,
                stacked_mask=lm.stacked_mask(params), gamma_t=gamma_t,
                transport=tp)
            out[tp] = (tree_leaves(tree_map(lambda p, u: p - u, params,
                                            upd)), tree_leaves(mem),
                       wire, eff)
        torch.cuda.synchronize(dev)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    a, b = out["perleaf"], out["bucketed"]
    diff = [i for i, (x, y) in enumerate(zip(a[0] + a[1], b[0] + b[1]))
            if not torch.equal(x, y)]
    if diff or a[2:] != b[2:]:
        fail(f"perleaf and bucketed differ on the card: leaves {diff}, "
             f"bytes {a[2:]} vs {b[2:]}")
    print(f"transports on the card: perleaf == bucketed bit for bit over "
          f"{len(a[0])} parameter and {len(a[1])} EF memory leaves at "
          f"gamma_t 0.07 (effective bytes {float(a[3])})", flush=True)


def kinds_trainer(dev, shapes) -> None:
    """Phase 4f: the trainer's other optimizer kinds and microbatches at
    full width through ``launch.train``, the launch counts set to 0
    just before each run and read just after; then a run made
    non-finite that must raise ``DivergenceError``."""
    from repro_torch.core.health import DivergenceError
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    if 4 * sum(int(np.prod(sh)) for sh in shapes) != DENSE_BYTES:
        fail(f"paper-lm-100m holds {sum(int(np.prod(sh)) for sh in shapes)}"
             f" parameters, not {DENSE_BYTES // 4}")
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    base = MAIN_ARGS + ["--gamma", "0.01"]
    for label, extra, steps, per_step, nbytes in (
            ("nonadaptive", ["--opt", "nonadaptive", "--eta", "0.1"], 2,
             one_codec, COMPRESSED_BYTES),
            ("sls", ["--opt", "sls"], 2, {}, DENSE_BYTES),
            ("sgd", ["--opt", "sgd"], 1, {}, DENSE_BYTES),
            ("dense", ["--opt", "dense"], 1, {}, DENSE_BYTES),
            ("csgd_asss microbatches 2", ["--microbatches", "2"], 2,
             one_codec, COMPRESSED_BYTES)):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(base + extra + ["--steps", str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"kinds [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]}, effective "
              f"{[x['effective_wire_bytes'] for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * steps:
                fail(f"[kinds {label}] {name} launched {c} times in "
                     f"{steps} steps, want {per_step.get(name, 0) * steps}")
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[kinds {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"])
               != (nbytes, nbytes) for x in log):
            fail(f"[kinds {label}] bytes {[x['wire_bytes'] for x in log]}, "
                 f"want {nbytes} a step")
        searched = label in ("sls", "csgd_asss microbatches 2")
        if not all(x["n_evals"] >= 1 if searched else
                   (x["n_evals"] == 0 and x["alpha"] == float(np.float32(
                       0.1))) for x in log):
            fail(f"[kinds {label}] alpha {[x['alpha'] for x in log]}, "
                 f"n_evals {[x['n_evals'] for x in log]}")
    ops.reset_launch_counts()
    try:
        log = train.main(base + ["--opt", "sgd", "--eta", "inf",
                                 "--max-consecutive-skips", "2",
                                 "--steps", "5"])
    except DivergenceError as e:
        if (e.step, e.last_good_step, e.consecutive) != (1, -1, 2) \
                or any(ops.launch_counts().values()):
            fail(f"DivergenceError at step {e.step}, last good step "
                 f"{e.last_good_step}, {e.consecutive} skips, launches "
                 f"{ops.launch_counts()}; want step 1, -1, 2 and none")
        print(f"kinds [sgd --eta inf --max-consecutive-skips 2]: raised "
              f"DivergenceError: {e}", flush=True)
    else:
        fail(f"--eta inf ran {len(log)} steps without DivergenceError")


def runtime_trainer(dev, root: Path) -> None:
    """Phase 4g: the trainer's runtime beyond one step at full width
    through ``launch.train``, the launch counts set to 0 just before
    each run and read just after: local-steps rounds (``csgd_asss`` and
    ``nonadaptive``), bf16 EF memory, and checkpoints saved, resumed and
    restored on the card."""
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    base = MAIN_ARGS + ["--gamma", "0.01"]

    def checked_run(label, extra, steps):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"runtime [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != one_codec.get(name, 0) * steps:
                fail(f"[runtime {label}] {name} launched {c} times in "
                     f"{steps} rounds, want {one_codec.get(name, 0) * steps}")
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[runtime {label}] non-finite loss or skipped rounds: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"])
               != (COMPRESSED_BYTES, COMPRESSED_BYTES) for x in log):
            fail(f"[runtime {label}] bytes {[x['wire_bytes'] for x in log]}"
                 f", want {COMPRESSED_BYTES} a round")
        if not all(x["n_evals"] >= 1 for x in log):
            fail(f"[runtime {label}] n_evals {[x['n_evals'] for x in log]}:"
                 " every local step runs the Armijo search")
        return log, params, state

    local = ["--local-steps", "2", "--microbatches", "2"]
    checked_run("local steps 2", local, LOCAL_ROUNDS)
    checked_run("local steps 2, nonadaptive",
                local + ["--opt", "nonadaptive", "--eta", "0.1"],
                LOCAL_ROUNDS)
    _, _, state = checked_run("ef-dtype bfloat16",
                              ["--ef-dtype", "bfloat16"], BF16_STEPS)
    mem = tree_leaves(state.memory)
    mem_bytes = sum(m.numel() * m.element_size() for m in mem)
    if not all(m.dtype == torch.bfloat16 and m.is_cuda for m in mem) \
            or mem_bytes != EF_BYTES["bfloat16"]:
        fail(f"[runtime ef-dtype bfloat16] EF memory "
             f"{sorted({str(m.dtype) for m in mem})}, {mem_bytes} B; want "
             f"bf16 leaves on the card, {EF_BYTES['bfloat16']} B")
    del state, mem

    # checkpoints: 2 steps saved after each, then --resume to 4
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "run")
        _, params, state = train.run(base + ["--steps", "2", "--ckpt-dir",
                                             d, "--ckpt-every", "1"])
        rank_dir = train.rank_dir(d, 0)
        step_dir = Path(rank_dir) / "step_0000000002"
        if ckpt.all_steps(rank_dir) != [1, 2] or state.step != 2:
            fail(f"checkpoints {ckpt.all_steps(rank_dir)} after 2 steps, "
                 "want [1, 2]")
        on_disk = sum(f.stat().st_size for f in step_dir.iterdir())
        cfg = get_config("paper-lm-100m")
        skel = lm.init_params(cfg, seed=1, device=dev)
        skeleton = {"params": skel, "state": init_train_state(
            skel, RunConfig(model=cfg, shape=ShapeConfig(256, 8)))}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tree, meta = ckpt.restore(rank_dir, skeleton, step=2)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        del skeleton, skel
        saved = tree_leaves(params) + tree_leaves(state.memory)
        back = tree_leaves(tree["params"]) + tree_leaves(
            tree["state"].memory)
        if meta != {"step": 2, "world_size": 1} or len(saved) != len(
                back) or not all(b.is_cuda and torch.equal(a, b)
                                 for a, b in zip(saved, back)) \
                or tree["state"].alpha_prev != state.alpha_prev:
            fail(f"the checkpoint of step 2 ({meta}) does not restore on "
                 "the card bit-identical to the tensors saved")
        del tree, back, saved
        t0 = time.perf_counter()
        ckpt.save(str(tmp / "timed"), 2, {"params": params, "state": state})
        save_s = time.perf_counter() - t0
        del params, state
        shutil.rmtree(tmp / "timed")
        print(f"runtime [checkpoint]: step 2 restored on the card "
              f"bit-identical (params and EF memory); save {save_s:.3f} s, "
              f"restore {restore_s:.3f} s; {on_disk} B on disk (EF memory "
              f"float32, {2 * EF_BYTES['float32']} B of tensors)",
              flush=True)
        log, _, state = train.run(base + ["--steps", "4", "--ckpt-dir", d,
                                          "--resume"])
        print(f"runtime [resume]: logged steps {[x['step'] for x in log]}, "
              f"losses {[x['loss'] for x in log]}, step_s "
              f"{[round(x['step_s'], 4) for x in log]}", flush=True)
        if [x["step"] for x in log] != [2, 3] or state.step != 4 \
                or not all(np.isfinite(x["loss"]) for x in log):
            fail(f"--resume logged steps {[x['step'] for x in log]} and "
                 f"ended at step {state.step}: want a resume at step 2, "
                 "steps [2, 3], finite losses")
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def acgd_downlink_trainer(dev) -> None:
    """Phase 4h: ``--opt acgd`` and ``--downlink compressed`` at full
    width through ``launch.train``, the launch counts set to 0 just
    before each run and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils import tree_leaves
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    ragged = dict(ef_stats_telemetry=9, ef_apply=9, pack_words_ragged=18,
                  unpack_words_ragged=18)
    base = MAIN_ARGS + ["--steps", str(ACGD_STEPS)]
    for label, extra, per_step, up, down in (
            ("acgd", ["--opt", "acgd", "--eta", "0.1", "--momentum", "0.9",
                      "--gamma", "0.01"], one_codec,
             (COMPRESSED_BYTES, COMPRESSED_BYTES), None),
            ("downlink compressed", ["--downlink", "compressed", "--gamma",
                                     "0.01"], one_codec,
             (COMPRESSED_BYTES, COMPRESSED_BYTES),
             (COMPRESSED_BYTES, COMPRESSED_BYTES)),
            ("acgd downlink perleaf", ["--opt", "acgd", "--downlink",
                                       "compressed", "--transport",
                                       "perleaf", "--max-gamma", "0.1",
                                       "--gamma", "0.04", "--downlink-gamma",
                                       "0.04", "--value-bits", "8"], ragged,
             (ADAPTIVE_STATIC, ADAPTIVE_EFFECTIVE[0]),
             (ADAPTIVE_STATIC, ADAPTIVE_EFFECTIVE[0]))):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log, _, state = train.run(base + extra)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        pairs = {d: [(x.get(f"{p}wire_bytes"),
                      x.get(f"{p}effective_wire_bytes")) for x in log]
                 for d, p in (("up", ""), ("down", "downlink_"))}
        print(f"acgd/downlink [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; losses "
              f"{[x['loss'] for x in log]}; alpha "
              f"{[x['alpha'] for x in log]}; n_evals "
              f"{[x['n_evals'] for x in log]}; (static, effective) bytes "
              f"up {pairs['up']}, down {pairs['down']}; cum_effective "
              f"{[x['cum_effective_wire_bytes'] for x in log]}; peak "
              f"memory {peak / 2**30:.2f} GiB", flush=True)
        for name, c in counts.items():
            if c != per_step.get(name, 0) * ACGD_STEPS:
                fail(f"[{label}] {name} launched {c} times in {ACGD_STEPS} "
                     f"steps, want {per_step.get(name, 0) * ACGD_STEPS}")
        if len(log) != ACGD_STEPS or not all(np.isfinite(x["loss"])
                                             for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[{label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if any((x["wire_bytes"], x["effective_wire_bytes"]) != up
               for x in log):
            fail(f"[{label}] uplink bytes, want {up} a step")
        if down is None:
            if any("downlink_wire_bytes" in x for x in log) \
                    or state.downlink is not None:
                fail(f"[{label}] a downlink without --downlink compressed")
        else:
            if any((x["downlink_wire_bytes"],
                    x["downlink_effective_wire_bytes"]) != down
                   for x in log):
                fail(f"[{label}] downlink bytes, want {down} a step")
            want_cum = ACGD_STEPS * (up[1] + down[1])
            if log[-1]["cum_effective_wire_bytes"] != want_cum:
                fail(f"[{label}] cum_effective_wire_bytes "
                     f"{log[-1]['cum_effective_wire_bytes']}, want "
                     f"{want_cum}")
            mem = state.downlink.memory
            if mem.dtype != torch.float32 or not mem.is_cuda \
                    or mem.numel() != SERVER_WORDS:
                fail(f"[{label}] server memory {mem.dtype} {mem.device} "
                     f"{mem.numel()} words, want f32 on the card, "
                     f"{SERVER_WORDS}")
            print(f"  server memory: {mem.numel()} f32 words "
                  f"({mem.numel() * 4} B) on {mem.device}", flush=True)
        if "acgd" in label:
            if not all(x["n_evals"] == 0 and x["alpha"] == float(
                    np.float32(0.1)) for x in log):
                fail(f"[{label}] alpha {[x['alpha'] for x in log]}, n_evals "
                     f"{[x['n_evals'] for x in log]}: want 0.1 and 0")
            vel = tree_leaves(state.velocity)
            nbytes = sum(v.numel() * v.element_size() for v in vel)
            if not all(v.dtype == torch.float32 and v.is_cuda for v in vel) \
                    or nbytes != DENSE_BYTES:
                fail(f"[{label}] velocity {nbytes} B, want f32 leaves on "
                     f"the card, {DENSE_BYTES} B")
            print(f"  velocity: {len(vel)} f32 leaves, {nbytes} B on the "
                  "card", flush=True)
        del state


def check_roundtrip(dev, gen, shapes, stacked) -> None:
    """Phase 4h: ``roundtrip_rows`` against ``decode_rows(encode_rows)``
    through the CUDA codec, bit for bit, at the downlink's rows of every
    compressed leaf of paper-lm-100m: 32-bit and 8-bit values at gamma
    0.01, and ragged 8-bit rows at count 41 of 102."""
    from repro_torch.comm import wire
    from repro_torch.comm.downlink import downlink_plan
    from repro_torch.core.compression import Compressor
    from repro_torch.core.leafmath import compress_leaf, leaf_count
    for label, comp, gamma_t in (
            ("32-bit", Compressor(gamma=0.01, method="block_topk"), None),
            ("8-bit", Compressor(gamma=0.01, method="block_topk",
                                 value_bits=8), None),
            ("ragged 8-bit", Compressor(gamma=0.04, method="block_topk",
                                        max_gamma=0.1, value_bits=8),
             np.float32(0.04))):
        rows = 0
        for ln in downlink_plan(shapes, stacked, comp).leaves:
            if ln.dense:
                continue
            x = torch.randn((ln.L, ln.d), generator=gen, device=dev) * 1e-3
            vals, idx, _ = compress_leaf(x, comp, ln.stacked)
            count = leaf_count(comp, ln.spec, gamma_t, ln.d)
            counts = None if count is None else wire.row_counts(
                count, ln.L, dev)
            rv, ri = wire.roundtrip_rows(vals, idx, ln.spec, counts=counts)
            wv, wi = wire.decode_rows(wire.encode_rows(
                vals, idx, ln.spec, counts=counts), ln.spec)
            torch.cuda.synchronize(dev)
            if not (torch.equal(rv.view(torch.int32), wv.view(torch.int32))
                    and torch.equal(ri, wi)):
                fail(f"roundtrip_rows differs from the CUDA codec's round "
                     f"trip at {label}, leaf {ln.index} ({ln.L}, {ln.d})")
            rows += ln.L
        print(f"roundtrip_rows [{label}]: bit-identical to decode_rows("
              f"encode_rows) through the CUDA codec over {rows} rows"
              + (f" at count {comp.block_k_t(gamma_t)} of "
                 f"{comp.block_k()}" if gamma_t is not None else ""),
              flush=True)


def profile_downlink(dev, cfg) -> None:
    """Phase 4h: one warm full-width step of ``acgd --downlink
    compressed`` at gamma 0.01 under torch.profiler, as in 4b (the host
    time of the ``train_step.downlink`` span among the spans); then the
    server round alone (``apply_downlink`` on that step's mean updates'
    shapes, from one batch's gradients) under the profiler: its sort,
    the downlink's ``block_extract_sparse``, and its other passes."""
    from repro_torch.comm.downlink import apply_downlink
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, value_and_grad
    comp = Compressor(gamma=0.01, method="block_topk")
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(kind="acgd", compressor=comp,
                                              downlink="compressed"))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        for step in range(2):
            batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
            params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
        prof, wall_ms = profiled(
            dev, lambda: train_step(params, state, batch, run))
        spans = report_profile(
            "acgd downlink", prof, wall_ms,
            ("ef_stats_telemetry_kernel", "ef_apply_kernel",
             "pack_words_kernel", "unpack_words_kernel"))
        if len(spans) != 4 or "train_step.downlink" not in spans \
                or min(spans.values()) <= 0:
            fail(f"the profiler saw acgd downlink spans {spans}, want "
                 "grad, exchange, downlink and metrics, each timed")
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        flat = [g.float() * 1e-2 for g in tree_flatten(grads)[0]]
        flat_s = tree_flatten(lm.stacked_mask(params))[0]
        del grads
        server = state.downlink
        server_prof, server_ms = profiled(
            dev, lambda: apply_downlink(flat, flat_s, comp, server))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    groups = {}
    for ev in server_prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0 and ev.device_type != torch.autograd.DeviceType.CPU:
            g = kernel_group(ev.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
    ported = [g for g in groups if g.endswith("_kernel")]
    if ported or "sort" not in groups:
        fail(f"the server round alone ran {sorted(groups)}: want a sort "
             "and no kernel of the port")
    busy = sum(groups.values())
    print(f"profile [server round alone]: {server_ms:.2f} ms wall "
          f"(profiler on), device busy {busy:.3f} ms: sort (the "
          f"downlink's block_extract_sparse) {groups['sort']:.3f} ms, "
          f"other passes {busy - groups['sort']:.3f} ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items())),
          flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors bit for bit: dtype, shape and every byte."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def trees_equal(a, b) -> bool:
    from repro_torch.utils import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(bits_equal(x, y)
                                      for x, y in zip(la, lb))


def overlap_trainer(dev, root: Path) -> None:
    """Phase 4i: ``--transport overlap`` at full width through
    ``launch.train``, the launch counts set to 0 just before each run and
    read just after: delay 0 against bucketed bit for bit (32- and 8-bit
    values), the delay-1 warm-up and stale aggregate against bucketed
    bit for bit, local steps and an adaptive budget at delay 1 with the
    EF identity on the embedding leaf, and a delay-1 checkpoint resumed
    on the card bit for bit."""
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.comm.bucket import decode_buckets
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.comm.overlap import OverlapConfig, OverlapCtx, \
        init_overlap_state
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import _tree_plan, worker_compress_aggregate
    from repro_torch.core.leafmath import scatter_layers
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ef_acc
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, tree_leaves, \
        value_and_grad
    cfg = get_config("paper-lm-100m")
    base = MAIN_ARGS + ["--gamma", "0.01"]
    ov = ["--transport", "overlap", "--overlap-chunks", str(OVERLAP_CHUNKS)]

    def checked_run(label, extra, steps, want=None):
        """``steps`` steps of ``base + extra``; fails on a non-finite
        loss, a skipped step, a ragged launch or launches other than
        ``want`` (a dict of counts) when given."""
        torch.cuda.reset_peak_memory_stats(dev)
        # what earlier runs still hold counts in the peak: report both
        live = torch.cuda.memory_allocated(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"overlap [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; (static, "
              f"effective) bytes "
              f"{[(x['wire_bytes'], x['effective_wire_bytes']) for x in log]}"
              f"; staleness {[x.get('staleness') for x in log]}; losses "
              f"{[x['loss'] for x in log]}; gamma "
              f"{[x['gamma'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[overlap {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if counts.get("pack_words_ragged") or counts.get(
                "unpack_words_ragged"):
            fail(f"[overlap {label}] ragged codec launches {counts}")
        if want is not None and counts != want:
            fail(f"[overlap {label}] launches {counts}, want {want}")
        return log, params, state, counts, peak

    def same_run(label, a, b, keys=("wire_bytes", "effective_wire_bytes",
                                    "gamma")):
        """Runs ``a`` and ``b`` (log, params, state): parameters, EF
        memory and the logged ``keys`` bit for bit."""
        if not trees_equal(a[1], b[1]) or not trees_equal(a[2].memory,
                                                          b[2].memory):
            fail(f"[overlap {label}] parameters or EF memory differ")
        for k in keys:
            if [x[k] for x in a[0]] != [x[k] for x in b[0]]:
                fail(f"[overlap {label}] {k} {[x[k] for x in a[0]]} != "
                     f"{[x[k] for x in b[0]]}")

    # ---- delay 0: bucketed over the ring, bit for bit --------------------
    times = {}
    for bits in ("32", "8"):
        extra = ["--value-bits", bits]
        buck = checked_run(f"bucketed {bits}-bit", extra, OVERLAP_STEPS)
        d0 = checked_run(f"delay 0 {bits}-bit",
                         extra + ov + ["--overlap-delay", "0"],
                         OVERLAP_STEPS, want=buck[3])
        same_run(f"delay 0 {bits}-bit", buck[:3], d0[:3])
        if any(x["staleness"] != 0.0 for x in d0[0]):
            fail("[overlap delay 0] staleness must read 0")
        times[f"bucketed {bits}-bit"] = [x["step_s"] for x in buck[0][1:]]
        times[f"delay 0 {bits}-bit"] = [x["step_s"] for x in d0[0][1:]]
        print(f"overlap [delay 0 {bits}-bit]: parameters, EF memory, wire "
              f"and effective bytes and gamma_t bit-identical to bucketed "
              f"after {OVERLAP_STEPS} steps; peak {d0[4] / 2**30:.2f} GiB "
              f"vs {buck[4] / 2**30:.2f}", flush=True)
        del buck, d0

    # ---- delay 1: the warm-up and the stale aggregate --------------------
    b1 = checked_run("bucketed 1 step", [], 1)
    o1 = checked_run("delay 1, 1 step", ov, 1, want=b1[3])
    init = lm.init_params(cfg, seed=0, device=dev)
    if not trees_equal(o1[1], init):
        fail("[overlap delay 1] step 1 moved the parameters: the warm-up "
             "applies the zero payload")
    if not trees_equal(o1[2].memory, b1[2].memory):
        fail("[overlap delay 1] step 1's EF memory differs from bucketed's")
    zero_eff = float(init_overlap_state(
        [p.shape for p in tree_leaves(init)],
        tree_flatten(lm.stacked_mask(init))[0],
        Compressor(gamma=0.01, method="block_topk")).eff_wire)
    del init, o1
    o2 = checked_run("delay 1, 2 steps", ov, 2,
                     want={k: 2 * v for k, v in b1[3].items()})
    if not trees_equal(o2[1], b1[1]):
        fail("[overlap delay 1] the parameters after step 2 differ from "
             "bucketed's after step 1: step 2 applies step 1's payload")
    if [x["staleness"] for x in o2[0]] != [0.0, 1.0] or \
            [x["effective_wire_bytes"] for x in o2[0]] != [
                zero_eff, b1[0][0]["effective_wire_bytes"]]:
        fail(f"[overlap delay 1] staleness "
             f"{[x['staleness'] for x in o2[0]]} (want 0, 1), effective "
             f"bytes {[x['effective_wire_bytes'] for x in o2[0]]} (want "
             f"{zero_eff} then bucketed step 1's)")
    print(f"overlap [delay 1]: step 1 a zero update with bucketed's EF "
          f"memory, step 2 bucketed step 1's parameters, bit-identical; "
          f"staleness 0, 1; effective bytes {zero_eff} (the zero payload) "
          f"then {b1[0][0]['effective_wire_bytes']}; carried payload "
          f"{o2[2].overlap.payload.numel()} int32 words and "
          f"{o2[2].overlap.dense.numel()} dense f32 on "
          f"{o2[2].overlap.payload.device}", flush=True)
    del b1, o2

    def ef_identity(label, run_cfg, state, eta):
        """One exchange on the card from ``state`` (its EF memory, carried
        payload and gamma_t) on a fresh gradient: on the embedding leaf,
        decode(own current payload) + m' == m + eta*g bit for bit."""
        params = lm.init_params(cfg, seed=3, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(7).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        opt = run_cfg.optimizer
        smask = lm.stacked_mask(params)
        created = init_process_group(dev)
        try:
            out = worker_compress_aggregate(
                grads, state.memory, eta, opt.compressor,
                stacked_mask=smask, gamma_t=state.gamma,
                transport="overlap",
                transport_ctx=OverlapCtx(opt.overlap, state.overlap))
        finally:
            if created:
                torch.distributed.destroy_process_group()
        flat_g, flat_s = tree_flatten(grads)[0], tree_flatten(smask)[0]
        plan = _tree_plan(flat_g, flat_s, opt.compressor)
        lane = max((ln for ln in plan.leaves if not ln.dense),
                   key=lambda ln: ln.L * ln.d)
        vals, idx = decode_buckets(plan, out[5].payload[None])[lane.index]
        own = scatter_layers(vals[0], idx[0], lane.L, lane.d)
        m = tree_flatten(state.memory)[0][lane.index].reshape(lane.L,
                                                              lane.d)
        m2 = tree_flatten(out[1])[0][lane.index].reshape(lane.L, lane.d)
        acc = ef_acc(m, flat_g[lane.index].reshape(lane.L, lane.d),
                     torch.tensor([eta], device=dev))
        if not bits_equal(own + m2, acc):
            fail(f"[overlap {label}] the EF identity decode(own) + m' == "
                 f"m + eta*g breaks on leaf {lane.index} ({lane.L}, "
                 f"{lane.d}) in {int((own + m2 != acc).sum())} entries")
        print(f"overlap [{label}]: EF identity decode(own) + m' == m + "
              f"eta*g bit for bit on leaf {lane.index} ({lane.L}, "
              f"{lane.d}), eta {eta}", flush=True)

    # ---- local steps and an adaptive budget at delay 1 -------------------
    def overlap_cfg(comp, **kw):
        return RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                         microbatches=kw.get("local_steps", 1),
                         optimizer=OptimizerConfig(
                             compressor=comp, transport="overlap",
                             overlap=OverlapConfig(n_chunks=OVERLAP_CHUNKS),
                             **kw))

    comp01 = Compressor(gamma=0.01, method="block_topk")
    local = ["--local-steps", "2", "--microbatches", "2"]
    one_codec = dict.fromkeys(ops.launch_counts(), 0)
    one_codec.update(ef_stats_telemetry=OVERLAP_LOCAL, ef_apply=OVERLAP_LOCAL,
                     pack_words=OVERLAP_LOCAL, unpack_words=OVERLAP_LOCAL)
    lo = checked_run("delay 1, local steps 2", ov + local, OVERLAP_LOCAL,
                     want=one_codec)
    ef_identity("delay 1, local steps 2",
                overlap_cfg(comp01, local_steps=2), lo[2], 1.0)
    del lo
    adaptive = ["--max-gamma", "0.1", "--gamma", "0.04"]
    ab = checked_run("bucketed, adaptive 10%", adaptive, OVERLAP_LOCAL)
    ao = checked_run("delay 1, adaptive 10%", ov + adaptive, OVERLAP_LOCAL,
                     want=ab[3])
    if ao[0][1]["effective_wire_bytes"] != ab[0][0]["effective_wire_bytes"]:
        fail("[overlap adaptive] step 2 must report the carried step-1 "
             "effective bytes")
    ef_identity("delay 1, adaptive 10%", overlap_cfg(Compressor(
        gamma=0.04, max_gamma=0.1, method="block_topk")), ao[2], 0.05)
    del ab, ao

    # ---- a delay-1 checkpoint, restored on the card and resumed ----------
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "overlap")
        straight = checked_run("delay 1, 4 steps", ov, 4)
        times["delay 1"] = [x["step_s"] for x in straight[0][1:]]
        _, _, saved = train.run(base + ov + ["--steps", "2", "--ckpt-dir",
                                             d, "--ckpt-every", "2"])
        skel = lm.init_params(cfg, seed=1, device=dev)
        tree, _ = ckpt.restore(train.rank_dir(d, 0), {
            "params": skel,
            "state": init_train_state(skel, overlap_cfg(comp01))},
            step=2)
        back = tree["state"].overlap
        if not (bits_equal(back.payload, saved.overlap.payload)
                and bits_equal(back.dense, saved.overlap.dense)
                and back.payload.device == saved.overlap.payload.device
                and back.eff_wire == saved.overlap.eff_wire
                and back.seeded == saved.overlap.seeded == 1.0):
            fail("[overlap checkpoint] the carried state of step 2 does not "
                 "restore on the card bit-identical")
        del tree, back, skel, saved
        log, params, state = train.run(base + ov + [
            "--steps", "4", "--ckpt-dir", d, "--resume"])
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or not (
                bits_equal(state.overlap.payload,
                           straight[2].overlap.payload)
                and bits_equal(state.overlap.dense,
                               straight[2].overlap.dense)):
            fail("[overlap checkpoint] a resume from step 2 to 4 differs "
                 "from 4 uninterrupted steps")
        print(f"overlap [checkpoint]: step 2 restored on the card with its "
              f"carried payload; resumed to 4 bit-identical to 4 "
              f"uninterrupted steps (parameters, EF memory, carried "
              f"payload); staleness {[x['staleness'] for x in log]}",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, t in times.items():
        print(f"overlap warm step_s [{label}]: {t}", flush=True)


def gossip_trainer(dev, root: Path) -> None:
    """Phase 4j: ``--transport gossip`` at full width through
    ``launch.train`` on one worker (ring(1): no edge), the launch counts
    set to 0 just before each run and read just after: against bucketed
    from the same seed at 32 and 8 bits (EF memory bit for bit,
    parameters equal, bytes and gamma_t equal, bucketed's launches, v 0
    and lr 1 after every step), and a checkpoint after 2 steps resumed
    to 4, bit for bit with 4 straight steps."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    base = MAIN_ARGS + ["--gamma", "0.01"]
    gossip = ["--transport", "gossip", "--topology", "ring"]

    def checked_run(label, extra, steps, want=None, first=0):
        """Steps ``first`` ... ``steps`` - 1 of ``base + extra``, (v, lr)
        read after each; fails on a non-finite loss, a skipped step, a
        ragged launch or launches other than ``want`` when given."""
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        seen = []
        real = train.train_step

        def recording(*a, **k):
            out = real(*a, **k)
            if out[1].gossip is not None:
                seen.append((float(out[1].gossip.v),
                             float(out[1].gossip.lr)))
            return out
        train.train_step = recording
        try:
            ops.reset_launch_counts()
            log, params, state = train.run(base + extra + ["--steps",
                                                           str(steps)])
            counts = ops.launch_counts()
        finally:
            train.train_step = real
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"gossip [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; (static, "
              f"effective) bytes "
              f"{[(x['wire_bytes'], x['effective_wire_bytes']) for x in log]}"
              f"; losses {[x['loss'] for x in log]}; gamma "
              f"{[x['gamma'] for x in log]}; (v, lr) {seen}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps - first or not all(np.isfinite(x["loss"])
                                        for x in log) \
                or any(x["steps_skipped"] for x in log):
            fail(f"[gossip {label}] non-finite loss or skipped steps: "
                 f"{[x['loss'] for x in log]}")
        if counts.get("pack_words_ragged") or counts.get(
                "unpack_words_ragged"):
            fail(f"[gossip {label}] ragged codec launches {counts}")
        if want is not None and counts != want:
            fail(f"[gossip {label}] launches {counts}, want {want}")
        if "--transport" in extra and seen != [(0.0, 1.0)] * len(log):
            fail(f"[gossip {label}] (v, lr) after each step {seen}, want "
                 "(0, 1): one worker has no neighbour")
        return log, params, state, counts, peak

    def trees_value_equal(a, b) -> bool:
        from repro_torch.utils import tree_leaves
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    times = {}
    for bits in ("32", "8"):
        extra = ["--value-bits", bits]
        buck = checked_run(f"bucketed {bits}-bit", extra, GOSSIP_STEPS)
        gos = checked_run(f"gossip {bits}-bit", extra + gossip,
                          GOSSIP_STEPS, want=buck[3])
        if not trees_equal(gos[2].memory, buck[2].memory):
            fail(f"[gossip {bits}-bit] EF memory differs from bucketed's")
        if not trees_value_equal(gos[1], buck[1]):
            fail(f"[gossip {bits}-bit] parameters differ from bucketed's")
        for k in ("wire_bytes", "effective_wire_bytes", "gamma"):
            if [x[k] for x in gos[0]] != [x[k] for x in buck[0]]:
                fail(f"[gossip {bits}-bit] {k} {[x[k] for x in gos[0]]} "
                     f"!= bucketed's {[x[k] for x in buck[0]]}")
        if gos[2].gossip.v.device != dev:
            fail("[gossip] the GossipState is not on the card")
        times[f"bucketed {bits}-bit"] = [x["step_s"] for x in buck[0][1:]]
        times[f"gossip {bits}-bit"] = [x["step_s"] for x in gos[0][1:]]
        print(f"gossip [{bits}-bit]: EF memory bit-identical, parameters "
              f"equal, wire and effective bytes and gamma_t equal to "
              f"bucketed after {GOSSIP_STEPS} steps with bucketed's "
              f"launches {buck[3]}; peak {gos[4] / 2**30:.2f} GiB vs "
              f"{buck[4] / 2**30:.2f}", flush=True)
        del buck, gos

    # ---- a checkpoint after 2 steps, resumed to 4 -----------------------
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "gossip")
        straight = checked_run("gossip 4 steps", gossip, 4)
        times["gossip 4 steps"] = [x["step_s"] for x in straight[0][1:]]
        checked_run("gossip 2 steps, saved", gossip + [
            "--ckpt-dir", d, "--ckpt-every", "2"], 2)
        log, params, state, _, _ = checked_run(
            "gossip resumed to 4", gossip + ["--ckpt-dir", d, "--resume"], 4,
            first=2)
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or not (
                bits_equal(state.gossip.v, straight[2].gossip.v)
                and bits_equal(state.gossip.lr, straight[2].gossip.lr)):
            fail("[gossip checkpoint] a resume from step 2 to 4 differs "
                 "from 4 uninterrupted steps")
        print("gossip [checkpoint]: resumed from step 2 to 4 bit-identical "
              "to 4 uninterrupted steps (parameters, EF memory, v, lr)",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, t in times.items():
        print(f"gossip warm step_s [{label}]: {t}", flush=True)


def fault_trainer(dev, root: Path) -> dict:
    """Phase 4k: the hostile-wire layer at full width through
    ``launch.train`` on one worker, the launch counts set to 0 just
    before each run and read just after: the decode verdicts (on by
    default) against ``guards_disabled()`` bit for bit with the same
    launches on bucketed at 32 and 8 bits and on perleaf at a 10% budget,
    and the exchange alone timed each way; a NaN round that quarantines
    every compressed row and keeps the EF memory; bitflip and count
    faults on ragged perleaf through the CUDA codec, guarded and not,
    each corrupted row and its decode equal to the CPU port's; the
    wrapper around overlap (delay 1) and gossip outside its burst equal
    to them bit for bit; a checkpoint inside a burst, resumed.  Returns
    the phase's times and ratios, which ``main`` prints again near the
    end of the output."""
    import shutil

    from repro_torch.comm import faults, wire
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten, value_and_grad
    cfg = get_config("paper-lm-100m")
    base = MAIN_ARGS + ["--gamma", "0.01"]
    perleaf = ["--transport", "perleaf", "--value-bits", "8"] + ADAPTIVE_ARGS

    def checked_run(label, extra, steps, want=None, skips=0):
        """``steps`` steps of ``base + extra``; fails on launches other
        than ``want`` when given, or ``skips`` (None: any) skipped
        steps."""
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        ops.reset_launch_counts()
        log, params, state = train.run(base + extra + ["--steps",
                                                       str(steps)])
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - live
        print(f"faults [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; losses "
              f"{[x['loss'] for x in log]}; rows_quarantined "
              f"{[x['rows_quarantined'] for x in log]}; skipped "
              f"{[x['steps_skipped'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB above the {live / 2**30:.2f} GiB "
              "live before the run", flush=True)
        if len(log) != steps or (skips is not None
                                 and log[-1]["steps_skipped"] != skips):
            fail(f"[faults {label}] {log[-1]['steps_skipped']} skipped "
                 f"steps, want {skips}")
        if want is not None and counts != want:
            fail(f"[faults {label}] launches {counts}, want {want}")
        return log, params, state, counts

    def same(label, a, b, keys=("wire_bytes", "effective_wire_bytes",
                                "gamma", "loss")):
        if not trees_equal(a[1], b[1]) or not trees_equal(a[2].memory,
                                                          b[2].memory):
            fail(f"[faults {label}] parameters or EF memory differ")
        for k in keys:
            if [x[k] for x in a[0]] != [x[k] for x in b[0]]:
                fail(f"[faults {label}] {k} {[x[k] for x in a[0]]} != "
                     f"{[x[k] for x in b[0]]}")

    # ---- (a) the verdicts on a clean wire: guarded == unguarded ---------
    times = {}
    for label, extra in (("bucketed 32-bit", []),
                         ("bucketed 8-bit", ["--value-bits", "8"]),
                         ("perleaf 10% budget", perleaf)):
        g = checked_run(f"{label}, guarded", extra, FAULT_STEPS)
        with faults.guards_disabled():
            u = checked_run(f"{label}, unguarded", extra, FAULT_STEPS,
                            want=g[3])
        same(f"{label} guarded vs unguarded", g, u)
        if any(x["rows_quarantined"] for x in g[0]):
            fail(f"[faults {label}] a clean wire quarantined rows")
        times[label] = ([x["step_s"] for x in g[0][1:]],
                        [x["step_s"] for x in u[0][1:]])
        print(f"faults [{label}]: guarded == unguarded bit for bit after "
              f"{FAULT_STEPS} steps (parameters, EF memory, bytes, gamma_t, "
              f"losses) with the same launches {g[3]}", flush=True)
        del g, u

    # the exchange alone, guarded and unguarded in turns, from one state
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(compressor=Compressor(
                        gamma=0.01, method="block_topk")))
    created = init_process_group(dev)
    try:
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=8)
        batch = {k: v.to(dev) for k, v in pipe.batch(0).items()}
        params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(1).items()}
        _, grads = value_and_grad(lambda p: lm.loss_fn(p, batch, cfg),
                                  params)
        smask = lm.stacked_mask(params)
        comp = run.optimizer.compressor

        def exchange():
            return worker_compress_aggregate(grads, state.memory, 0.0345,
                                             comp, stacked_mask=smask)

        def unguarded():
            with faults.guards_disabled():
                return exchange()
        def step():
            return train_step(params, state, batch, run)

        def step_unguarded():
            with faults.guards_disabled():
                return step()
        ex = {k: [] for k in ("guarded", "unguarded", "step guarded",
                              "step unguarded")}
        for _ in range(2):
            exchange(), unguarded(), step(), step_unguarded()
        for _ in range(FAULT_REPS):
            for name, fn in (("guarded", exchange),
                             ("unguarded", unguarded),
                             ("step unguarded", step_unguarded),
                             ("step guarded", step)):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                ex[name].append((time.perf_counter() - t0) * 1e3)
        dev_ms = {name: device_ms(fn) for name, fn in
                  (("guarded", exchange), ("unguarded", unguarded))}
    finally:
        if created:
            torch.distributed.destroy_process_group()
    del params, state, grads, batch
    med = {k: statistics.median(v) for k, v in ex.items()}
    ex = {k: [round(x, 3) for x in v] for k, v in ex.items()}
    for label, (gt, ut) in times.items():
        print(f"faults warm step_s [{label}]: guarded {gt}, unguarded {ut}; "
              f"ratio of means {statistics.mean(gt) / statistics.mean(ut):.4f}",
              flush=True)
    print(f"faults [exchange alone, bucketed 32-bit, {FAULT_REPS} in turns]: "
          f"guarded median {med['guarded']:.3f} ms, unguarded "
          f"{med['unguarded']:.3f} ms, ratio "
          f"{med['guarded'] / med['unguarded']:.4f}; device only "
          f"{dev_ms['guarded']:.3f} vs {dev_ms['unguarded']:.3f} ms, ratio "
          f"{dev_ms['guarded'] / dev_ms['unguarded']:.4f}; each run (ms) "
          f"{ex['guarded']} / {ex['unguarded']}", flush=True)
    print(f"faults [train_step, bucketed 32-bit, {FAULT_REPS} in turns from "
          f"one state]: guarded median {med['step guarded']:.3f} ms, "
          f"unguarded {med['step unguarded']:.3f} ms, ratio "
          f"{med['step guarded'] / med['step unguarded']:.4f}; each run "
          f"(ms) {ex['step guarded']} / {ex['step unguarded']}", flush=True)
    summary = {
        "exchange_ms": [round(med["guarded"], 3),
                        round(med["unguarded"], 3)],
        "exchange_ratio": round(med["guarded"] / med["unguarded"], 4),
        "exchange_device_ms": [round(dev_ms["guarded"], 3),
                               round(dev_ms["unguarded"], 3)],
        "step_ms": [round(med["step guarded"], 3),
                    round(med["step unguarded"], 3)],
        "step_ratio": round(med["step guarded"] / med["step unguarded"], 4),
        "warm_step_ratio_of_means": {
            label: round(statistics.mean(gt) / statistics.mean(ut), 4)
            for label, (gt, ut) in times.items()}}

    # ---- the means at W = 3 on the card: a synthetic gathered decode ----
    # guarded, a true division by the valid-row count; unguarded, the
    # product with f32(1/3) jitted XLA computes for the static W.  Each
    # row's indices are its own, so the sums are exact and only the
    # division rounds.
    from repro_torch.core.dcsgd import _consume_decoded_leaf
    L, d, k = 4, 3 * 4096, 4096
    gen = torch.Generator().manual_seed(3)
    vals = torch.randn((3, L, k), generator=gen)
    idx = (torch.arange(k)[None, None, :] * 3
           + torch.arange(3)[:, None, None]).expand(3, L, k).to(torch.int32)
    acc = torch.randn((L, d), generator=gen)
    total = torch.zeros((L, d))
    total.view(L, k, 3).copy_(vals.permute(1, 2, 0))
    want = {True: total / torch.full((L, 1), 3.0),
            False: total * float(np.float32(1.0) / np.float32(3.0))}
    for guarded in (True, False):
        out = _consume_decoded_leaf(
            acc.to(dev), acc.to(dev), acc.to(dev), vals.to(dev),
            idx.to(dev), L, d, 3, 0, False, None, None, acc.to(dev),
            verdict=torch.ones((3, L), dtype=torch.bool, device=dev)
            if guarded else None)
        if not bits_equal(out[0].cpu(), want[guarded]):
            fail(f"[faults W=3 mean, guarded={guarded}] the card's mean is "
                 "not the CPU's "
                 + ("true division" if guarded else "reciprocal product"))
    parted = int((want[True] != want[False]).sum())
    if not parted:
        fail("[faults W=3 mean] the division and the product never part")
    print(f"faults [W = 3 mean on the card]: guarded == the true division "
          f"by 3, unguarded == the product with f32(1/3), bit for bit; the "
          f"two part in {parted} of {L * d} entries", flush=True)
    summary["w3_mean_parted"] = [parted, L * d]

    # ---- (b) a NaN round: every compressed row quarantined --------------
    burst = ["--fault-nonfinite", "1.0", "--fault-start-step", "1",
             "--fault-steps", "1"]
    clean = checked_run("clean, 1 step", [], 1)
    nan = checked_run("nonfinite at step 1", burst, 2, want={
        k: 2 * v for k, v in clean[3].items()})
    leaves = tree_flatten(nan[1])[0]
    plan = build_bucket_plan([p.shape for p in leaves],
                             tree_flatten(lm.stacked_mask(nan[1]))[0],
                             Compressor(gamma=0.01, method="block_topk"))
    rows = sum(ln.L for ln in plan.leaves if not ln.dense)
    before = tree_flatten(clean[2].memory)[0]
    after = tree_flatten(nan[2].memory)[0]
    if nan[0][0] != {**clean[0][0], "step_s": nan[0][0]["step_s"]}:
        fail(f"[faults nonfinite] step 0 {nan[0][0]} differs from the "
             f"clean run's {clean[0][0]}")
    if [x["rows_quarantined"] for x in nan[0]] != [0.0, float(rows)]:
        fail(f"[faults nonfinite] rows_quarantined "
             f"{[x['rows_quarantined'] for x in nan[0]]}, want 0 then "
             f"{rows}")
    frozen = [ln.index for ln in plan.leaves if not ln.dense
              and not bits_equal(after[ln.index], before[ln.index])]
    if frozen or not all(bool(torch.isfinite(p).all()) for p in leaves):
        fail(f"[faults nonfinite] EF memory of compressed leaves {frozen} "
             "moved, or a parameter is not finite")
    print(f"faults [nonfinite at step 1]: step 0 the clean run's; step 1 "
          f"quarantined {rows} rows (all compressed), kept the EF memory "
          f"of {len(plan.compressed_ids)} compressed leaves bit for bit, "
          f"0 skips, finite parameters", flush=True)
    del clean, nan, leaves, before, after

    # ---- (c) bitflip and count faults through the ragged CUDA codec ------
    recs = []
    real_corrupt, real_decode = faults.maybe_corrupt, wire.decode_rows

    def rec_corrupt(rows_in, spec, lane, rpw):
        out = real_corrupt(rows_in, spec, lane, rpw)
        st = faults._ACTIVE[-1]
        recs.append(dict(rows=rows_in.clone(), out=out.clone(), spec=spec,
                         lane=lane, rpw=rpw, cfg=st.cfg, step=st.step))
        return out

    def rec_decode(payload, spec):
        vals, idx = real_decode(payload, spec)
        if recs and recs[-1]["spec"] == spec and "vals" not in recs[-1]:
            recs[-1].update(vals=vals.clone(), idx=idx.clone())
        return vals, idx
    hostile = ["--fault-bitflip", "1.0", "--fault-count", "1.0",
               "--fault-seed", "11"]
    ok = checked_run("perleaf clean", perleaf, 2)
    for label, extra, skips in (("guarded", [], 0),
                                ("--no-quarantine", ["--no-quarantine"],
                                 None)):
        recs.clear()
        faults.maybe_corrupt, wire.decode_rows = rec_corrupt, rec_decode
        try:
            got = checked_run(f"perleaf bitflip+count, {label}",
                              perleaf + hostile + extra, 2, want=ok[3],
                              skips=skips)
        finally:
            faults.maybe_corrupt, wire.decode_rows = real_corrupt, \
                real_decode
        n_bad = n_rows = 0
        for r in recs:
            with faults.active_faults(r["cfg"], r["step"]):
                cpu_out = faults.maybe_corrupt(r["rows"].cpu(), r["spec"],
                                               r["lane"], r["rpw"])
            cv, ci = wire.decode_rows(cpu_out, r["spec"])
            gv, gi = r["vals"].cpu(), r["idx"].cpu()
            same_v = (gv.view(torch.int32) == cv.view(torch.int32)) | (
                torch.isnan(gv) & torch.isnan(cv))
            if not (torch.equal(r["out"].cpu(), cpu_out) and bool(
                    same_v.all()) and torch.equal(gi, ci)):
                fail(f"[faults {label}] lane {r['lane']} step {r['step']}: "
                     "the card's corrupted rows or their decode differ "
                     "from the CPU port's")
            counts = cpu_out[:, 0]
            bad = (counts < 0) | (counts > r["spec"].full_count)
            n_bad += int(bad.sum())
            n_rows += counts.numel()
            # a count read as -1 masks every field: the row decodes to 0
            if bool((gv[counts < 0] != 0).any()):
                fail(f"[faults {label}] a row whose count reads -1 decoded "
                     "a live value in the CUDA ragged unpack")
        if not recs or not n_bad:
            fail(f"[faults {label}] no corrupted count reached the decode")
        q = [x["rows_quarantined"] for x in got[0]]
        if (label == "guarded") != bool(q[-1]):
            fail(f"[faults {label}] rows_quarantined {q}")
        print(f"faults [perleaf bitflip+count, {label}]: {len(recs)} leaf "
              f"decodes, {n_bad} of {n_rows} rows with a corrupted count "
              f"(-1: every field masked, or 2*full+7: every field "
              f"unmasked), each corrupted row and its decode (values, "
              f"indices) equal to the CPU port's, no device assert; "
              f"rows_quarantined {q}, skipped "
              f"{[x['steps_skipped'] for x in got[0]]}", flush=True)
        del got
    recs.clear()
    del ok

    # ---- (d) the wrapper outside its burst: the inner transport ---------
    quiet = ["--fault-bitflip", "1.0", "--fault-nonfinite", "1.0",
             "--fault-start-step", "100"]
    for label, extra in (("overlap delay 1", ["--transport", "overlap"]),
                         ("gossip", ["--transport", "gossip"])):
        a = checked_run(label, extra, 2)
        b = checked_run(f"faulty({label}), outside the burst",
                        extra + quiet, 2, want=a[3])
        same(f"faulty({label})", a, b)
        carried = (a[2].overlap, b[2].overlap) if a[2].overlap is not None \
            else (a[2].gossip, b[2].gossip)
        if not all(bits_equal(x, y) for x, y in zip(
                tree_flatten(vars(carried[0]))[0],
                tree_flatten(vars(carried[1]))[0])
                if isinstance(x, torch.Tensor)):
            fail(f"[faults {label}] the carried state differs")
        print(f"faults [faulty({label}) outside the burst]: bit for bit "
              f"its inner transport (parameters, EF memory, carried "
              f"state, bytes, losses), launches {a[3]}", flush=True)
        del a, b

    # ---- (e) a checkpoint inside a burst, resumed -----------------------
    mid = ["--value-bits", "8", "--fault-bitflip", "0.5",
           "--fault-nonfinite", "0.2", "--fault-start-step", "1",
           "--fault-steps", "3"]
    tmp = root / "_smoke_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        d = str(tmp / "faults")
        straight = checked_run("burst, 4 steps", mid, 4)
        checked_run("burst, 2 steps, saved", mid + [
            "--ckpt-dir", d, "--ckpt-every", "2"], 2)
        log, params, state = train.run(base + mid + [
            "--steps", "4", "--ckpt-dir", d, "--resume"])
        keys = ("loss", "rows_quarantined", "steps_skipped")
        if [x["step"] for x in log] != [2, 3] or not trees_equal(
                params, straight[1]) or not trees_equal(
                    state.memory, straight[2].memory) or [
                [x[k] for k in keys] for x in log] != [
                [x[k] for k in keys] for x in straight[0][2:]] \
                or state.health != straight[2].health:
            fail("[faults checkpoint] a resume inside the burst differs "
                 "from 4 uninterrupted steps")
        print(f"faults [checkpoint]: resumed at step 2 of a 3-step burst, "
              f"bit for bit with 4 straight steps (parameters, EF memory, "
              f"losses, rows_quarantined "
              f"{[x['rows_quarantined'] for x in straight[0]]}, health)",
              flush=True)
        del straight, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


def exchange_collectives(prof) -> list[str]:
    """Names of the collective calls and NCCL kernels that the profile
    shows inside the ``train_step.exchange`` span."""
    cpu = torch.autograd.DeviceType.CPU
    evs = list(prof.events())
    spans = [e for e in evs if e.name == "train_step.exchange"
             and e.device_type == cpu]
    if len(spans) != 1:
        fail(f"the profile has {len(spans)} train_step.exchange spans")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    names = []
    for e in evs:
        if e.device_type != cpu or not (lo <= e.time_range.start
                                        and e.time_range.end <= hi):
            continue
        low = e.name.lower()
        if "nccl" in low or "c10d" in low or "all_reduce" in low \
                or "allreduce" in low or "all_gather" in low \
                or "allgather" in low:
            names.append(e.name)
        names += [k.name for k in getattr(e, "kernels", ())
                  if "nccl" in k.name.lower()]
    return names


def profile_gossip(dev, cfg, comp) -> None:
    """Phase 4j: one warm full-width gossip step under torch.profiler, as
    in 4b, beside a bucketed one: the exchange span of gossip shows no
    collective and no NCCL kernel, bucketed's shows its all-gather and
    all-reduce (the check's control); the peak device memory above what
    was live before the run."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    for transport in ("bucketed", "gossip"):
        run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                        optimizer=OptimizerConfig(compressor=comp,
                                                  transport=transport))
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        created = init_process_group(dev)
        try:
            params = lm.init_params(cfg, seed=0, device=dev)
            state = init_train_state(params, run)
            pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                                 global_batch=8)
            for step in range(2):
                batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
                params, state, _ = train_step(params, state, batch, run)
            batch = {k: v.to(dev) for k, v in pipe.batch(2).items()}
            prof, wall_ms = profiled(
                dev, lambda: train_step(params, state, batch, run))
        finally:
            if created:
                torch.distributed.destroy_process_group()
        peak = torch.cuda.max_memory_allocated(dev) - live
        label = f"trainer {transport}, one worker"
        spans = report_profile(label, prof, wall_ms,
                               ("ef_stats_telemetry_kernel",
                                "ef_apply_kernel", "pack_words_kernel",
                                "unpack_words_kernel"))
        if len(spans) != 4 or min(spans.values()) <= 0:
            fail(f"the profiler saw {label} train_step spans {spans}, "
                 "want 4 timed")
        coll = exchange_collectives(prof)
        print(f"  exchange span collectives: {sorted(set(coll))}; peak "
              f"memory {peak / 2**30:.2f} GiB above the "
              f"{live / 2**30:.2f} GiB live before the run", flush=True)
        if transport == "gossip" and coll:
            fail(f"[gossip profile] the exchange span shows collectives "
                 f"{sorted(set(coll))}")
        if transport == "bucketed" and not coll:
            fail("[gossip profile] the control failed: bucketed's "
                 "exchange span shows no collective")
        del params, state, prof


def run_single(dev, cfg, comp, steps, label, make_opt) -> dict:
    """Phases 4c and 4h: a single-node optimizer (``make_opt(compressor)``
    -> CSGD-ASSS or ACGD) on the full-width model through the library
    entry point; returns the launch counts of the run."""
    from repro_torch.core.compression import Compressor, tree_wire_bytes
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves
    seen = {}

    class Recording(Compressor):
        """Keeps the (acc, sent, residual) of the largest leaf, so the EF
        identity is checked on what the optimizer really passed."""

        def compress_dense(self, x, gamma_t=None):
            sent, resid = super().compress_dense(x, gamma_t)
            if x.numel() >= seen.get("n", 0):
                seen.update(n=x.numel(), x=x, sent=sent, resid=resid)
            return sent, resid

    params = lm.init_params(cfg, seed=0, device=dev)
    n_leaves = sum(p.numel() >= comp.min_compress_size
                   for p in tree_leaves(params))
    want_bytes = float(tree_wire_bytes(params, comp))
    opt = make_opt(Recording(gamma=comp.gamma, method=comp.method))
    state = opt.init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                         global_batch=8)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    log = []
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
        t0 = time.perf_counter()
        params, state, aux = opt.step(
            lambda p, b=batch: lm.loss_fn(p, b, cfg), params, state)
        loss = float(aux.loss)
        torch.cuda.synchronize(dev)
        log.append(dict(step_s=time.perf_counter() - t0, loss=loss,
                        alpha=float(getattr(aux, "alpha", aux.eta)),
                        n_evals=getattr(aux, "n_evals", 0),
                        wire_bytes=float(aux.wire_bytes)))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: launches {counts}; step_s "
          f"{[round(x['step_s'], 4) for x in log]}; losses "
          f"{[x['loss'] for x in log]}; alpha {[x['alpha'] for x in log]}; "
          f"n_evals {[x['n_evals'] for x in log]}; wire bytes "
          f"{log[0]['wire_bytes']} (want {want_bytes}); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        want = n_leaves * steps if name in ("block_stats",
                                            "threshold_split") else 0
        if n != want:
            fail(f"[{label}] {name} launched {n} times in {steps} steps "
                 f"over {n_leaves} compressed leaves, want {want}")
    if not all(np.isfinite(x["loss"]) for x in log):
        fail(f"[{label}] non-finite loss: {[x['loss'] for x in log]}")
    if any(x["wire_bytes"] != want_bytes for x in log):
        fail(f"[{label}] wire bytes {[x['wire_bytes'] for x in log]} != "
             f"accounted {want_bytes}")
    if not torch.equal(seen["sent"] + seen["resid"], seen["x"]):
        fail(f"[{label}] sent + residual != acc on the largest leaf")
    print(f"{label}: EF identity exact on a {seen['n']}-element leaf; "
          f"{int((seen['sent'] != 0).sum())} entries sent", flush=True)
    seen.clear()
    batch = {k: v.to(dev) for k, v in pipe.batch(steps).items()}
    report_profile(label, *profiled(dev, lambda: opt.step(
        lambda p: lm.loss_fn(p, batch, cfg), params, state)),
        ("block_stats_kernel", "threshold_split_kernel"))
    return counts


def csgd_smoke(dev, steps: int = 3) -> None:
    """Phase 5b: CSGD-ASSS on the 2-layer variant, the card against the
    CPU's plain versions from the same weights and batches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compression import Compressor
    from repro_torch.core.csgd import CSGDConfig, csgd_asss
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models import lm
    cfg = get_smoke_config("paper-lm-100m")
    runs = []
    for d in (dev, torch.device("cpu")):
        params = lm.init_params(cfg, seed=0, device=d)
        opt = csgd_asss(CSGDConfig(compressor=Compressor(
            gamma=0.01, method="block_topk")))
        state = opt.init(params)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                             global_batch=4)
        out = []
        for step in range(steps):
            batch = {k: v.to(d) for k, v in pipe.batch(step).items()}
            params, state, aux = opt.step(
                lambda p, b=batch: lm.loss_fn(p, b, cfg), params, state)
            out.append((float(aux.loss), float(aux.alpha), aux.n_evals))
        runs.append(out)
    for (lc, ac, nc), (lh, ah, nh) in zip(*runs):
        if abs(lc - lh) > 1e-4 * abs(lh) or ac != ah or nc != nh:
            fail(f"csgd smoke on the card {runs[0]} disagrees with the "
                 f"CPU {runs[1]}")
    print(f"csgd smoke card vs cpu: (loss, alpha, n_evals) {runs[0]} vs "
          f"{runs[1]}", flush=True)


def ptxas_entries(name: str, kernels) -> list[tuple[str, int, int]]:
    """(entry, registers, spill bytes) of each of the named kernels that
    ``nvcc -Xptxas -v`` reported when it built ``csrc/<name>.cu``; entry
    is the kernel's name and its template integers, e.g.
    ``rmsnorm_kernel 10``."""
    from repro_torch.kernels import _build
    out, entry, spill = [], None, 0
    for line in _build.build_log(name).splitlines():
        m = re.search(rf"Compiling entry function '\w*?({'|'.join(kernels)})"
                      r"(\w*)'", line)
        if m:
            entry = " ".join([m.group(1)] + re.findall(r"Li(\d+)E",
                                                        m.group(2)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), spill))
            entry, spill = None, 0
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors of one
    sign pattern (their int16 bit patterns are monotone per sign)."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def bf16_ulp_err(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """Largest |got - want| in bf16 ulps of |want|, once ``atol`` is taken
    off (the two sum in f32 in different orders, so a value near zero may
    differ by that much before rounding)."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp(min=atol)).exponent - 8)
    return float(((got.float() - w).abs() - atol).clamp(min=0).div(ulp)
                 .max())


def check_serving_kernels(dev, report) -> None:
    """Phase 3 for the serving kernels: each against its plain version on
    the card at the shapes serving gives it, timed beside its bound and,
    where one exists, the library call computing the same function."""
    import torch.nn.functional as F_
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv_wkv import wkv_forward
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    # flash attention, bf16 (the tensor-core route): qwen1.5-4b prefill
    # and the edge cases, through the transposed (B, S, H, D) views the
    # model hands over
    flash = ptxas_entries("flash_attention_sm90",
                          ["flash_attention_sm90_kernel"])
    norm = ptxas_entries("rmsnorm", ["rmsnorm_stream_kernel",
                                     "rmsnorm_kernel"])
    for name, entries in (("flash_attention_sm90", flash), ("rmsnorm", norm)):
        if not entries or any(spill for _, _, spill in entries):
            fail(f"csrc/{name}.cu: ptxas reported spills, or no kernel: "
                 f"{entries}")
    smem = _build.load("flash_attention_sm90").flash_attention_sm90_smem_bytes
    for entry, regs, _ in flash:
        print(f"ptxas {entry}: {regs} registers, "
              f"{smem(int(entry.split()[-1]))} bytes of dynamic shared "
              "memory, no spills", flush=True)
    print(f"ptxas rmsnorm: {len(norm)} kernels, no spills, "
          f"{min(r for _, r, _ in norm)}-{max(r for _, r, _ in norm)} "
          f"registers; {[r for e, r, _ in norm if e == 'rmsnorm_kernel 10']}"
          " at 10 chunks a lane (D 2560)", flush=True)

    def bshd(b, h, s, d):
        return randn(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)

    edge_ulps = []
    for (b, h, sq, sk, d) in ((1, 2, 1, 70, 64), (2, 3, 100, 100, 64),
                              (1, 2, 37, 150, 128), (2, 2, 300, 300, 32),
                              (1, 4, 77, 333, 128)):
        qs, ks, vs = bshd(b, h, sq, d), bshd(b, h, sk, d), bshd(b, h, sk, d)
        for causal in (True, False):
            for window in (None, 64):
                e = bf16_ulp_err(
                    flash_attention(qs, ks, vs, causal=causal,
                                    window=window),
                    ref.mha_reference(qs, ks, vs, causal=causal,
                                      window=window), 1e-5)
                edge_ulps.append(e)
                if not e <= 1:
                    fail(f"flash_attention bf16 {(b, h, sq, sk, d)} causal="
                         f"{causal} window={window} is {e} bf16 ulp (beyond"
                         " 1e-5) from the plain version (limit 1)")
    B, H, S, D = 4, 20, 2048, 128
    q, k, v = bshd(B, H, S, D), bshd(B, H, S, D), bshd(B, H, S, D)
    got = flash_attention(q, k, v, causal=True)
    want = ref.mha_reference(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    ulps = bf16_ulp_err(got, want, 1e-5)
    if not ulps <= 1:
        fail(f"flash_attention (4, 20, 2048, 128) bf16 is {ulps} bf16 ulp "
             "(beyond 1e-5) from the plain version (limit 1)")
    print(f"flash_attention bf16: {len(edge_ulps)} edge cases within "
          f"{max(edge_ulps):.3f} bf16 ulp, (4, 20, 2048, 128) causal "
          f"{ulps:.3f}", flush=True)
    small_errs = []
    for (b, h, sq, sk, d), causal, window in (
            ((2, 3, 300, 300, 128), True, 64),
            ((2, 3, 300, 300, 64), False, None),
            ((1, 4, 77, 333, 128), True, None),
            ((2, 2, 150, 150, 32), True, None),
            ((2, 2, 1, 150, 64), False, 64)):
        qs = randn(b, h, sq, d, scale=0.5)
        ks, vs = randn(b, h, sk, d, scale=0.5), randn(b, h, sk, d)
        e = float((flash_attention(qs, ks, vs, causal=causal, window=window)
                   - ref.mha_reference(qs, ks, vs, causal=causal,
                                       window=window)).abs().max())
        small_errs.append(e)
        if not e <= 3e-5:
            fail(f"flash_attention f32 {(b, h, sq, sk, d)} causal={causal} "
                 f"window={window} is {e} from the plain version (3e-5)")
    pairs = B * H * S * (S + 1) // 2
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = time_ms(lambda: flash_attention(qf, kf, vf, causal=True), reps=5)
    print(f"flash_attention f32 route (CUDA cores) at (4, 20, 2048, 128) "
          f"causal: {f32_ms:.4f} ms (bound "
          f"{4 * D * pairs / F32_OPS_PER_S * 1e3:.4f} ms at 67 TFLOP/s)",
          flush=True)
    del qf, kf, vf
    report["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_reference(q, k, v, causal=True)),
        library_ms=time_ms(lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bytes=4 * B * H * S * D * 2, ops=4 * D * pairs,
        ops_per_s=BF16_OPS_PER_S,
        note=f"(4, 20, 2048, 128) bf16 causal, {ulps:.3f} bf16 ulp; f32 "
             f"cases max err {max(small_errs):.2e}")
    r = report["flash_attention"]
    dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True))
    dev_lib = device_ms(lambda: F_.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    print(f"flash_attention bf16 {r['ms']:.4f} ms is "
          f"{r['ms'] / r['library_ms']:.2f}x F.scaled_dot_product_attention's"
          f" {r['library_ms']:.4f} ms; device only (profiler) {dev_ms:.4f} "
          f"and {dev_lib:.4f} ms", flush=True)
    del q, k, v, got, want

    # RMSNorm: qwen1.5-4b prefill and decode rows, rwkv6-1.6b prefill rows
    errs = {}
    for rows, d, dt in ((8192, 2560, torch.bfloat16),
                        (4, 2560, torch.bfloat16),
                        (4096, 2048, torch.bfloat16),
                        (4096, 2048, torch.float32)):
        x, w = randn(rows, d, dtype=dt), randn(d, dtype=dt)
        got, want = rmsnorm(x, w, 1e-5), ref.rmsnorm_reference(x, w, 1e-5)
        if dt == torch.bfloat16:
            ulps = bf16_ulps(got, want)
            if ulps > 1:
                fail(f"rmsnorm ({rows}, {d}) bf16 is {ulps} bf16 ulp from "
                     "the plain version (limit 1)")
            errs[(rows, d, "bf16")] = float((got.float()
                                             - want.float()).abs().max())
        else:
            e = float((got - want).abs().max())
            if not e <= 1e-5:
                fail(f"rmsnorm ({rows}, {d}) f32 is {e} from the plain "
                     "version (atol 1e-5)")
    x, w = randn(8192, 2560, dtype=torch.bfloat16), \
        randn(2560, dtype=torch.bfloat16)
    print(f"rmsnorm (8192, 2560) bf16 device only (profiler): "
          f"{device_ms(lambda: rmsnorm(x, w, 1e-5)):.4f} ms, F.rms_norm "
          f"{device_ms(lambda: F_.rms_norm(x, (2560,), w, 1e-5)):.4f} ms",
          flush=True)
    report["rmsnorm"] = dict(
        max_abs_err=errs[(8192, 2560, "bf16")],
        ms=time_ms(lambda: rmsnorm(x, w, 1e-5)),
        plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, w, 1e-5)),
        library_ms=time_ms(lambda: F_.rms_norm(x, (2560,), w, 1e-5)),
        bytes=2 * 8192 * 2560 * 2 + 2560 * 2, ops=8192 * 2560 * 4,
        note="(8192, 2560) bf16, qwen1.5-4b prefill; within 1 bf16 ulp "
             "at every shape")
    del x, w

    # WKV: rwkv6-1.6b prefill and one decode step
    wkv = ptxas_entries("rwkv_wkv", ["wkv_forward_kernel"])
    if not wkv or any(spill for _, _, spill in wkv):
        fail(f"csrc/rwkv_wkv.cu: ptxas reported spills, or no kernel: {wkv}")
    smem = _build.load("rwkv_wkv").wkv_forward_smem_bytes
    for entry, regs, _ in wkv:
        print(f"ptxas {entry}: {regs} registers, "
              f"{smem(int(entry.split()[-1]))} bytes of dynamic shared "
              "memory, no spills", flush=True)
    B, S, H, K = 4, 1024, 32, 64

    def wkv_inputs(s):
        return (randn(B, s, H, K, scale=0.3), randn(B, s, H, K, scale=0.3),
                randn(B, s, H, K), torch.sigmoid(randn(B, s, H, K)),
                randn(H, K, scale=0.1), randn(B, H, K, K, scale=0.1))
    wkv_ms, wkv_err = {}, {}
    for s_len in (1, S):
        args = wkv_inputs(s_len)
        y, sT = wkv_forward(*args)
        ry, rsT = ref.wkv_reference(*args)
        e = max(float((y - ry).abs().max()), float((sT - rsT).abs().max()))
        if not e <= 2e-5:
            fail(f"wkv_forward at S={s_len} is {e} from the plain version "
                 "(atol 2e-5)")
        wkv_ms[s_len], wkv_err[s_len] = time_ms(
            lambda: wkv_forward(*args)), e
    print(f"wkv_forward (4, S, 32, 64) f32: S = 1 (a decode step) "
          f"{wkv_ms[1]:.4f} ms (max err {wkv_err[1]:.2e}), S = 1024 "
          f"{wkv_ms[S]:.4f} ms (max err {wkv_err[S]:.2e}), device only "
          f"(profiler) {device_ms(lambda: wkv_forward(*args)):.4f} ms",
          flush=True)
    report["wkv_forward"] = dict(
        max_abs_err=e, ms=wkv_ms[S],
        plain_ms=time_ms(lambda: ref.wkv_reference(*args)),
        library_ms=None,
        bytes=(5 * B * S * H * K + 2 * B * H * K * K + H * K) * 4,
        # per (b, t, h): r.S and w*S + k^T v, 5 per state element; the
        # u term, (sum_k r u k) v, 3K + 2V
        ops=B * S * H * (5 * K * K + 5 * K),
        note="(4, 1024, 32, 64) f32, rwkv6-1.6b prefill; also S = 1")


def profile_serving(dev, arch, ctx, kernels_of_path) -> None:
    """One profiled prefill and one profiled decode step at full width."""
    from repro_torch.launch import serve
    model, params, prompt = serve.load(arch, False, SERVE_BATCH, ctx, dev)
    with torch.inference_mode():
        model.prefill(params, {"tokens": prompt},
                      capacity=ctx + SERVE_GEN)       # warm
        holder = {}
        prof, wall = profiled(dev, lambda: holder.update(out=model.prefill(
            params, {"tokens": prompt}, capacity=ctx + SERVE_GEN)))
        report_profile(f"{arch} prefill", prof, wall, kernels_of_path)
        logits, cache = holder.pop("out")
        tok = logits[:, -1:, :model.cfg.vocab_size].argmax(-1)
        model.decode_step(params, tok, cache, ctx)    # warm
        prof, wall = profiled(dev, lambda: model.decode_step(
            params, tok, cache, ctx + 1))
        report_profile(f"{arch} decode", prof, wall,
                       [k for k in kernels_of_path
                        if not k.startswith("flash_attention")])
    del model, params, prompt, logits, cache
    torch.cuda.empty_cache()


def run_serving(dev) -> dict:
    """Phase 4d: both serving paths at full width through the launcher;
    returns each path's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    counts_of = {}
    for arch, ctx, want, traced in SERVE_RUNS:
        ops.reset_launch_counts()
        res = serve.main(["--arch", arch, "--full", "--batch",
                          str(SERVE_BATCH), "--ctx", str(ctx), "--gen",
                          str(SERVE_GEN)])
        counts = ops.launch_counts()
        counts_of[arch] = counts
        print(f"serve [{arch}]: launches {counts}; prefill "
              f"{res['prefill_s']:.4f} s, decode "
              f"{res['decode_ms_per_step']:.3f} ms/step "
              f"({res['decode_tokens_per_s']:.1f} tokens/s), peak memory "
              f"{res['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        for name, n in counts.items():
            if n != want.get(name, 0):
                fail(f"[serve {arch}] {name} launched {n} times, want "
                     f"{want.get(name, 0)}")
        if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) \
                or not torch.isfinite(res["logits"]).all():
            fail(f"[serve {arch}] tokens {tuple(res['tokens'].shape)} or "
                 "non-finite logits")
        del res
        torch.cuda.empty_cache()
        profile_serving(dev, arch, ctx, traced)
    return counts_of


def serve_smoke(dev) -> None:
    """Phase 5c: both smoke serve configs on the card (kernels) and on the
    CPU (plain versions): equal tokens, logits within 1e-4 of max."""
    from repro_torch.launch import serve
    for arch, _, _, _ in SERVE_RUNS:
        args = ["--arch", arch, "--smoke", "--batch", "2", "--ctx", "96",
                "--gen", "4"]
        card, cpu = serve.main(args), serve.main(args + ["--device", "cpu"])
        err = float((card["logits"] - cpu["logits"]).abs().max())
        tol = 1e-4 * float(cpu["logits"].abs().max())
        if not torch.equal(card["tokens"], cpu["tokens"]) or not err <= tol:
            fail(f"serve smoke {arch} on the card (tokens "
                 f"{card['tokens'].tolist()}) disagrees with the CPU "
                 f"({cpu['tokens'].tolist()}): logits {err} > {tol}")
        print(f"serve smoke {arch} card vs cpu: tokens "
              f"{card['tokens'].tolist()} equal, logits max diff {err:.3e} "
              f"(limit {tol:.3e})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on "
             "a machine with an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.comm.bucket import build_bucket_plan
    from repro_torch.configs import get_config
    from repro_torch.core.acgd import AcgdConfig, acgd
    from repro_torch.core.armijo import ArmijoConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.csgd import CSGDConfig, csgd_asss
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import ef_topk, wire_pack
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.utils import tree_flatten

    # ---- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()),
          flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions at main-path shapes ----
    cfg = get_config("paper-lm-100m")
    comp = Compressor(gamma=0.01, method="block_topk")
    params = lm.init_params(cfg, seed=0, device=dev)
    leaves, _ = tree_flatten(params)
    stacked = tree_flatten(lm.stacked_mask(params))[0]
    shapes = [tuple(p.shape) for p in leaves]
    del params, leaves
    plan = build_bucket_plan(shapes, stacked, comp)
    rows = sum(ln.L * -(-ln.d // comp.block) for ln in plan.leaves
               if not ln.dense)
    k_b = comp.block_k()
    # k_b at the paper's gamma of 1%, 4% and 10%: 10, 41 and 102
    paper_ks = [Compressor(gamma=gm, method="block_topk").block_k()
                for gm in (0.01, 0.04, 0.1)]
    gen = torch.Generator(device=dev).manual_seed(1)
    m = torch.randn((rows, 1024), generator=gen, device=dev) * 1e-3
    g = torch.randn((rows, 1024), generator=gen, device=dev) * 1e-2
    eta = torch.tensor([0.0345], device=dev)
    report = {}

    tau, mom = ef_topk.ef_stats_telemetry(m, g, eta, k_b)
    rtau, rmom = ref.ef_block_stats_telemetry(m, g, eta, k_b)
    torch.cuda.synchronize()
    if not torch.equal(tau, rtau):
        fail(f"ef_stats_telemetry tau differs from the plain version in "
             f"{int((tau != rtau).sum())} of {rows} rows")
    ulp = max_ulp(mom.cpu().numpy(), rmom.cpu().numpy())
    if ulp > 8:
        fail(f"ef_stats_telemetry moments are {ulp} ulp from the plain "
             "version (limit 8)")
    report["ef_stats_telemetry"] = dict(
        max_abs_err=float((mom - rmom).abs().max()),
        ms=time_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, k_b)),
        plain_ms=time_ms(lambda: ref.ef_block_stats_telemetry(m, g, eta,
                                                              k_b)),
        bytes=rows * 1024 * 8 + rows * 12,
        # the function's work per element: the fma forming acc, |acc| and
        # the two squares (done in f64 here, counted as f32)
        ops=rows * 1024 * 6,
        note=f"moments max {ulp} ulp")

    sent, mnew = ef_topk.ef_apply(m, g, eta, tau)
    rsent, rmnew = ref.ef_block_update(m, g, eta, rtau)
    torch.cuda.synchronize()
    if not (torch.equal(sent, rsent) and torch.equal(mnew, rmnew)):
        fail("ef_apply differs from the plain version")
    if not torch.equal(sent + mnew, ref.ef_acc(m, g, eta)):
        fail("ef_apply breaks the EF identity sent + m' == fma(eta, g, m)")
    kept = float((sent != 0).sum()) / rows
    report["ef_apply"] = dict(
        max_abs_err=max(float((sent - rsent).abs().max()),
                        float((mnew - rmnew).abs().max())),
        ms=time_ms(lambda: ef_topk.ef_apply(m, g, eta, tau)),
        plain_ms=time_ms(lambda: ref.ef_block_update(m, g, eta, tau)),
        bytes=rows * 1024 * 16 + rows * 4, ops=rows * 1024 * 5,
        note=f"{kept:.2f} kept per block row (k_b={k_b})")

    # ef_block_stats through its only path, the per-leaf fused op without
    # moments, at the same rows; the counts of that call are its launches
    ops.reset_launch_counts()
    sent, mnew, btau = ops.fused_ef_compress(m, g, eta, comp.gamma,
                                             telemetry=False)
    ef_block_counts = ops.launch_counts()
    rbtau = ref.ef_block_stats(m, g, eta, k_b)
    torch.cuda.synchronize()
    want = dict.fromkeys(ef_block_counts, 0)
    want.update(ef_block_stats=1, ef_apply=1)
    if ef_block_counts != want:
        fail(f"fused_ef_compress(telemetry=False) launched "
             f"{ef_block_counts}, want {want}")
    if not same(btau, rbtau) or not same(btau, rtau):
        fail("ef_block_stats differs from the plain version")
    if not torch.equal(sent, rsent) or not torch.equal(mnew, rmnew):
        fail("fused_ef_compress(telemetry=False) differs from the plain "
             "versions")
    report["ef_block_stats"] = dict(
        max_abs_err=float((btau - rbtau).abs().max()),
        ms=time_ms(lambda: ef_topk.ef_block_stats(m, g, eta, k_b)),
        plain_ms=time_ms(lambda: ref.ef_block_stats(m, g, eta, k_b)),
        bytes=rows * 1024 * 8 + rows * 4, ops=rows * 1024 * 3,
        note="through ops.fused_ef_compress(telemetry=False)")
    # both EF pass-1 kernels at the paper's 1%, 4% and 10%: checked, then
    # timed with the host's launch and on the device alone
    for kb in paper_ks:
        t1, mom1 = ef_topk.ef_stats_telemetry(m, g, eta, kb)
        t2 = ef_topk.ef_block_stats(m, g, eta, kb)
        rt, rm = ref.ef_block_stats_telemetry(m, g, eta, kb)
        ulp = max_ulp(mom1.cpu().numpy(), rm.cpu().numpy())
        if not (same(t1, rt) and same(t2, rt)) or ulp > 8:
            fail(f"EF pass 1 at k_b={kb} differs from the plain version: "
                 f"tau in {int((t1 != rt).sum())} and {int((t2 != rt).sum())}"
                 f" of {rows} rows, moments {ulp} ulp (limit 8)")
        del t1, mom1, t2, rt, rm
        print(f"EF pass 1 ({rows}, 1024) k_b={kb}: bit-exact, moments "
              f"{ulp} ulp; ef_stats_telemetry "
              f"{time_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, kb)):.4f}"
              f" ms, device only "
              f"{device_ms(lambda: ef_topk.ef_stats_telemetry(m, g, eta, kb)):.4f}"
              f" ms; ef_block_stats "
              f"{time_ms(lambda: ef_topk.ef_block_stats(m, g, eta, kb)):.4f} "
              f"ms, device only "
              f"{device_ms(lambda: ef_topk.ef_block_stats(m, g, eta, kb)):.4f}"
              " ms", flush=True)
    del m, g, sent, mnew, rsent, rmnew, tau, rtau, mom, rmom, btau, rbtau

    check_wire(dev, gen, shapes, stacked, report)
    check_ragged_wire(dev, gen, shapes, stacked, report)

    csgd_rows = [-(-int(np.prod(sh)) // comp.block) for sh in shapes
                 if int(np.prod(sh)) >= comp.min_compress_size]
    check_dense_selection(dev, gen, csgd_rows, k_b, paper_ks, report)
    check_serving_kernels(dev, report)
    for name, r in report.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / r.get("ops_per_s", F32_OPS_PER_S) * 1e3
        r["bound_ms"] = max(byte_ms, ops_ms)
        r["bound_by"] = "bytes" if byte_ms >= ops_ms else "operations"
        lib = (f", library {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
        print(f"kernel {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms{lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{r['bytes']} B, {r['ops']} ops; {r['note']})", flush=True)

    # ---- 4. the trainer at full width through the kernels ---------------
    runs = {}
    one_codec = dict(ef_stats_telemetry=1, ef_apply=1, pack_words=1,
                     unpack_words=1)
    for label, gamma, bits, steps, per_step in (
            ("main", 0.01, 32, MAIN_STEPS, one_codec),
            ("value-bits 8", 0.01, 8, VB8_STEPS,
             dict(ef_stats_telemetry=1, ef_apply=1, pack_words=2,
                  unpack_words=2)),
            ("gamma 0.1", 0.1, 32, G10_STEPS, one_codec)):
        want_bytes = step_wire_bytes(shapes, stacked, Compressor(
            gamma=gamma, method="block_topk", value_bits=bits))
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(MAIN_ARGS + ["--gamma", str(gamma), "--value-bits",
                                      str(bits), "--steps", str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        runs[label] = counts
        print(f"trainer [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]} (want {want_bytes}); "
              f"n_evals {[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, n in counts.items():
            if n != per_step.get(name, 0) * steps:
                fail(f"[{label}] {name} launched {n} times in {steps} "
                     f"steps, want {per_step.get(name, 0) * steps}")
        if not all(np.isfinite(x["loss"]) for x in log):
            fail(f"[{label}] non-finite loss: {[x['loss'] for x in log]}")
        if any(x["wire_bytes"] != want_bytes for x in log):
            fail(f"[{label}] wire bytes {[x['wire_bytes'] for x in log]} "
                 f"!= accounted {want_bytes}")
        if any(x["steps_skipped"] for x in log):
            fail(f"[{label}] steps were skipped by the finite check")

    # ---- 4b. where one step's device time goes ---------------------------
    profile_step(dev, cfg, comp)
    profile_step(dev, cfg, Compressor(gamma=0.1, method="block_topk"),
                 "trainer gamma 0.1")

    # ---- 4c. single-node CSGD-ASSS at full width through its kernels -----
    csgd_counts = run_single(dev, cfg, comp, CSGD_STEPS, "csgd",
                             lambda c: csgd_asss(CSGDConfig(
                                 armijo=ArmijoConfig(), compressor=c)))

    # ---- 4d. serving at full width through its kernels -------------------
    serve_counts = run_serving(dev)

    # ---- 4e. the adaptive trainer: the ragged codec on a trainer path ---
    adaptive_counts = adaptive_trainer(dev, shapes, stacked)
    transports_agree(dev, cfg)
    profile_step(dev, cfg, Compressor(gamma=0.04, method="block_topk",
                                      max_gamma=0.1, value_bits=8),
                 "adaptive perleaf, gamma_t 0.04", transport="perleaf")

    # ---- 4f. the other optimizer kinds, microbatches, the breaker -------
    kinds_trainer(dev, shapes)
    profile_step(dev, cfg, comp, "trainer nonadaptive", kind="nonadaptive")
    profile_step(dev, cfg, comp, "trainer microbatches 2", microbatches=2)

    # ---- 4g. local steps, bf16 EF memory, checkpoints --------------------
    runtime_trainer(dev, root)
    profile_step(dev, cfg, comp, "trainer local steps 2", microbatches=2,
                 local_steps=2)

    # ---- 4h. ACGD and the compressed downlink ---------------------------
    acgd_downlink_trainer(dev)
    check_roundtrip(dev, gen, shapes, stacked)
    profile_downlink(dev, cfg)
    run_single(dev, cfg, comp, ACGD_SINGLE_STEPS, "acgd single-node",
               lambda c: acgd(AcgdConfig(compressor=c, eta=0.1,
                                         momentum=0.9)))

    # ---- 4i. the overlap transport: chunked ring, delay-1 double buffer --
    overlap_trainer(dev, root)
    profile_step(dev, cfg, comp, "trainer overlap delay 1",
                 transport="overlap")

    # ---- 4j. the gossip transport at one worker -------------------------
    gossip_trainer(dev, root)
    profile_gossip(dev, cfg, comp)

    # ---- 4k. the hostile wire: verdicts, quarantine, fault injection ----
    fault_summary = fault_trainer(dev, root)

    # ---- 5. small input: the card against the CPU's plain path ----------
    small = ["--smoke", "--steps", "2", "--seq-len", "33", "--global-batch",
             "4", "--compress-method", "block_topk", "--log-every", "1"]
    for label, extra in (
            ("csgd_asss", []), ("nonadaptive", ["--opt", "nonadaptive"]),
            ("sls", ["--opt", "sls"]),
            ("local steps 2", ["--local-steps", "2", "--microbatches", "2"]),
            ("ef-dtype bfloat16", ["--ef-dtype", "bfloat16"]),
            ("acgd", ["--opt", "acgd"]),
            ("downlink compressed", ["--downlink", "compressed"]),
            ("overlap delay 1", ["--transport", "overlap",
                                 "--overlap-chunks", "3"]),
            ("overlap delay 0", ["--transport", "overlap",
                                 "--overlap-delay", "0"]),
            ("gossip", ["--transport", "gossip"]),
            ("fault bitflip 0.1", ["--fault-bitflip", "0.1"])):
        on_card = train.main(small + extra)
        on_cpu = train.main(small + extra + ["--device", "cpu"])
        for a, b in zip(on_card, on_cpu):
            if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or any(
                    a.get(k) != b.get(k) for k in (
                        "wire_bytes", "downlink_effective_wire_bytes",
                        "cum_effective_wire_bytes", "staleness",
                        "rows_quarantined", "steps_skipped")):
                fail(f"{label} smoke run on the card {a} disagrees with "
                     f"the CPU {b}")
        print(f"{label} smoke card vs cpu: losses "
              f"{[x['loss'] for x in on_card]} vs "
              f"{[x['loss'] for x in on_cpu]}; rows_quarantined "
              f"{[x['rows_quarantined'] for x in on_card]}", flush=True)
    adaptive = small + ["--transport", "perleaf", "--max-gamma", "0.1",
                        "--gamma-schedule", "linear", "--gamma-ramp-steps",
                        "1"]
    on_card = train.main(adaptive)
    on_cpu = train.main(adaptive + ["--device", "cpu"])
    for a, b in zip(on_card, on_cpu):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or any(
                a[k] != b[k] for k in ("gamma", "wire_bytes",
                                       "effective_wire_bytes")):
            fail(f"adaptive perleaf smoke on the card {a} disagrees with "
                 f"the CPU {b}")
    print(f"adaptive perleaf smoke card vs cpu: losses "
          f"{[x['loss'] for x in on_card]} vs {[x['loss'] for x in on_cpu]},"
          f" effective bytes {[x['effective_wire_bytes'] for x in on_card]}",
          flush=True)
    csgd_smoke(dev)
    serve_smoke(dev)

    # ---- 6. results -----------------------------------------------------
    # launches: each kernel's count on the path that runs it — the
    # trainer, single-node CSGD, fused_ef_compress(telemetry=False), the
    # qwen1.5-4b serve run (flash attention, RMSNorm), the rwkv6-1.6b one
    # (WKV) or the adaptive perleaf trainer (the ragged codec)
    launches = dict(runs["main"])
    launches.update(block_stats=csgd_counts["block_stats"],
                    threshold_split=csgd_counts["threshold_split"],
                    ef_block_stats=ef_block_counts["ef_block_stats"],
                    flash_attention=serve_counts["qwen1.5-4b"][
                        "flash_attention"],
                    rmsnorm=serve_counts["qwen1.5-4b"]["rmsnorm"],
                    wkv_forward=serve_counts["rwkv6-1.6b"]["wkv_forward"],
                    pack_words_ragged=adaptive_counts["pack_words_ragged"],
                    unpack_words_ragged=adaptive_counts[
                        "unpack_words_ragged"])
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))
               for name, r in report.items()]
    # phase 4k's times again, where the end of the output keeps them
    print("faults summary (guarded, unguarded): "
          + json.dumps(fault_summary), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
