#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches and continues):

1. print the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a``, one compiler per source, all started together;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes paper-lm-100m's training step gives it (bit-exact; the pass-1
   moments within 8 ulp), and time both with CUDA events (median of 25
   runs) beside the kernel's byte bound at the H100's 3.35 TB/s;
4. run the trainer (``repro_torch.launch.train``) on paper-lm-100m at full
   width — 12 layers, d_model 768, vocab 16384, seq 256, global batch 8,
   ``--compress-method block_topk`` — for 4 steps, with every launch count
   set to 0 just before and read just after, then 2 steps at
   ``--value-bits 8`` the same way;
5. run the 2-layer smoke variant for 2 steps on the card and on the CPU
   (the plain versions, which the CPU tests hold against the JAX
   package) and compare losses and wire bytes;
6. print the kernels as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without that last line when there is no CUDA device or
when the repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
MAIN_STEPS, VB8_STEPS = 4, 2
MAIN_ARGS = ["--arch", "paper-lm-100m", "--compress-method", "block_topk",
             "--seq-len", "256", "--global-batch", "8", "--log-every", "1"]
REPLACES = {
    "ef_stats_telemetry": "src/repro/kernels/ef_topk.py:206",
    "ef_apply": "src/repro/kernels/ef_topk.py:107",
    "pack_words": "src/repro/kernels/wire_pack.py:109",
    "unpack_words": "src/repro/kernels/wire_pack.py:154",
}
SOURCES = {
    "ef_stats_telemetry": "src/repro_torch/csrc/ef_topk.cu",
    "ef_apply": "src/repro_torch/csrc/ef_topk.cu",
    "pack_words": "src/repro_torch/csrc/wire_pack.cu",
    "unpack_words": "src/repro_torch/csrc/wire_pack.cu",
}


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


def max_ulp(a, b) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


PORTED = ("ef_stats_telemetry_kernel", "ef_apply_kernel",
          "pack_words_kernel", "unpack_words_kernel")


def kernel_group(name: str) -> str:
    low = name.lower()
    if any(p in name for p in PORTED):
        return "ported EF/wire kernels"
    if any(s in low for s in ("gemm", "cutlass", "sm90_xmma", "cublas",
                              "nvjet")):
        return "matmul"
    if "sort" in low or "radix" in low:
        return "sort (block_extract_sparse)"
    if "nccl" in low:
        return "nccl"
    return "other"


def profile_step(dev, cfg, comp) -> None:
    """One warm full-width train step under torch.profiler: device time
    by kernel group and the device's idle share of the step."""
    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                    optimizer=OptimizerConfig(compressor=comp))
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
        torch.cuda.synchronize(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            train_step(params, state, batch, run)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if created:
            torch.distributed.destroy_process_group()
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
    print(f"profile: one step {wall_ms:.2f} ms wall (profiler on), device "
          f"busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.3f} ms ({ms / busy:.3f} of device time)")
    # host time in each phase of train_step: launches plus any wait for
    # the device (the Armijo trials and the metrics read values back)
    for name, ms in spans.items():
        print(f"  host {name}: {ms:.3f} ms ({ms / wall_ms:.3f} of wall)")
    if len(spans) != 4 or min(spans.values()) <= 0:
        fail(f"the profiler saw train_step spans {spans}, want 4 timed")
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {ms:8.3f} ms x{n:<4d} {key[:90]}")
    if busy <= 0:
        fail("the profiler saw no device time in the train step")


def step_wire_bytes(shapes, stacked, comp) -> float:
    """The bytes one step must put on the wire: the packed payload words
    plus the f32 dense leaves."""
    from repro_torch.comm.bucket import build_bucket_plan
    plan = build_bucket_plan(shapes, stacked, comp)
    return float(plan.total_words * 4 + sum(
        ln.L * ln.d * 4 for ln in plan.leaves if ln.dense))


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
    from repro_torch.core.compression import Compressor
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
    index_words = sum(ln.L * ln.spec.index_words for ln in plan.leaves
                      if not ln.dense)
    k_b = comp.block_k()
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
        # per element: the fma forming acc, |acc| and the two squares
        # (done in f64 here, counted as f32); per row: k_b rounds of a
        # 5-step warp max-reduce over 32 lanes
        ops=rows * 1024 * 6 + rows * k_b * 32 * 5 * 2,
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
    del m, g, sent, mnew, rsent, rmnew, tau, rtau, mom, rmom

    W = index_words
    srows, scols = wire_pack.stream_shape(W)
    fields = torch.randint(0, 1 << 16, (srows, scols * 2), generator=gen,
                           device=dev, dtype=torch.int32)
    words = wire_pack.pack_words(fields, 16)
    rwords = ref.pack_fields(fields, 16)
    if not torch.equal(words, rwords):
        fail("pack_words differs from the plain version")
    back = wire_pack.unpack_words(words, 16)
    rback = ref.unpack_fields(words, 16)
    if not torch.equal(back, rback) or not torch.equal(back, fields):
        fail("unpack_words differs from the plain version or the input")
    for bits in (4, 8):                    # the value widths, ragged too
        F = 32 // bits
        f2 = torch.randint(-2**31, 2**31 - 1, (97, 40 * F), generator=gen,
                           device=dev, dtype=torch.int32)
        cnt = torch.randint(0, 12, (97,), generator=gen, device=dev,
                            dtype=torch.int32)
        for c, period in ((None, 0), (cnt, 11)):
            w2 = wire_pack.pack_words(f2, bits, c, period)
            if not torch.equal(w2, ref.pack_fields(f2, bits, c, period)) \
                    or not torch.equal(
                        wire_pack.unpack_words(w2, bits, c, period),
                        ref.unpack_fields(w2, bits, c, period)):
                fail(f"wire kernels differ from the plain versions at "
                     f"bits={bits} ragged={c is not None}")
    report["pack_words"] = dict(
        max_abs_err=float((words.long() - rwords.long()).abs().max()),
        ms=time_ms(lambda: wire_pack.pack_words(fields, 16)),
        plain_ms=time_ms(lambda: ref.pack_fields(fields, 16)),
        bytes=srows * scols * 4 * 3, ops=srows * scols * 2 * 3,
        note=f"16-bit index stream {W} words")
    report["unpack_words"] = dict(
        max_abs_err=float((back.long() - rback.long()).abs().max()),
        ms=time_ms(lambda: wire_pack.unpack_words(words, 16)),
        plain_ms=time_ms(lambda: ref.unpack_fields(words, 16)),
        bytes=srows * scols * 4 * 3, ops=srows * scols * 2 * 3,
        note=f"16-bit index stream {W} words")
    del fields, words, rwords, back, rback
    for name, r in report.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(byte_ms, ops_ms)
        r["bound_by"] = "bytes" if byte_ms >= ops_ms else "operations"
        print(f"kernel {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{r['bytes']} B, {r['ops']} ops; {r['note']})", flush=True)

    # ---- 4. the trainer at full width through the kernels ---------------
    runs = {}
    for label, bits, steps, per_step in (
            ("main", 32, MAIN_STEPS, dict(ef_stats_telemetry=1, ef_apply=1,
                                          pack_words=1, unpack_words=1)),
            ("value-bits 8", 8, VB8_STEPS,
             dict(ef_stats_telemetry=1, ef_apply=1, pack_words=2,
                  unpack_words=2))):
        want_bytes = step_wire_bytes(shapes, stacked, Compressor(
            gamma=0.01, method="block_topk", value_bits=bits))
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        log = train.main(MAIN_ARGS + ["--value-bits", str(bits),
                                      "--steps", str(steps)])
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        runs[label] = counts
        print(f"trainer [{label}]: launches {counts}; step_s "
              f"{[round(x['step_s'], 4) for x in log]}; wire bytes "
              f"{[x['wire_bytes'] for x in log]} (want {want_bytes}); "
              f"n_evals {[x['n_evals'] for x in log]}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        for name, n in per_step.items():
            if counts[name] != n * steps:
                fail(f"[{label}] {name} launched {counts[name]} times in "
                     f"{steps} steps, want {n * steps}")
        if not all(np.isfinite(x["loss"]) for x in log):
            fail(f"[{label}] non-finite loss: {[x['loss'] for x in log]}")
        if any(x["wire_bytes"] != want_bytes for x in log):
            fail(f"wire bytes {[x['wire_bytes'] for x in log]} != "
                 f"accounted {want_bytes}")
        if any(x["steps_skipped"] for x in log):
            fail(f"[{label}] steps were skipped by the finite check")

    # ---- 4b. where one step's device time goes ---------------------------
    profile_step(dev, cfg, comp)

    # ---- 5. small input: the card against the CPU's plain path ----------
    small = ["--smoke", "--steps", "2", "--seq-len", "33", "--global-batch",
             "4", "--compress-method", "block_topk", "--log-every", "1"]
    on_card = train.main(small)
    on_cpu = train.main(small + ["--device", "cpu"])
    for a, b in zip(on_card, on_cpu):
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) \
                or a["wire_bytes"] != b["wire_bytes"]:
            fail(f"smoke run on the card {a} disagrees with the CPU {b}")
    print(f"smoke card vs cpu: losses {[x['loss'] for x in on_card]} vs "
          f"{[x['loss'] for x in on_cpu]}", flush=True)

    # ---- 6. results -----------------------------------------------------
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=runs["main"][name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None)
               for name, r in report.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
