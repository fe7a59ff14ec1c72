"""Time the exchange alone and a whole train step of paper-lm-100m at full
width (seq 256, batch 8, ``block_topk`` at gamma 0.01, one worker) for
one or more checkouts of this repo, each in processes of its own, in
turns.

    PYTHONPATH=src python -m repro_torch.launch.ab_step \\
        --tree _archive/parent --tree . --order 0,1,1,0 --reps 30 \\
        --out ab_step.json

Each entry of ``--order`` starts one process that imports ``repro_torch``
from ``<tree>/src`` alone, builds the model and its train state from
seed 0, takes one step, then times, in turns from that one state, the
bucketed exchange (``worker_compress_aggregate``) and the whole
``train_step`` at 32- and 8-bit values: wall time per call around a
device synchronisation, and the exchange's device time from the
profiler's kernel times.  Where the tree has the decode verdicts
(``repro_torch.comm.faults``), each is timed guarded (the default) and
under ``guards_disabled()`` as well.  The parent's and the change's
medians are then set side by side.  It needs one CUDA card; a
checkout's kernels are built in that checkout at its first process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: one process's timings, run with ``-c`` so that the script's directory
#: does not come first on ``sys.path``; argv: reps
_WORKER = "import runpy, sys; runpy.run_path(sys.argv[1], run_name='worker')"


def _measure(reps: int) -> dict:
    import torch

    from repro_torch.comm.exchange import init_process_group
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.core.compression import Compressor
    from repro_torch.core.dcsgd import worker_compress_aggregate
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train_step import init_train_state, train_step
    from repro_torch.models import lm
    from repro_torch.utils import value_and_grad
    try:
        from repro_torch.comm.faults import guards_disabled
    except ImportError:                   # a tree without the verdicts
        guards_disabled = None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = get_config("paper-lm-100m")
    created = init_process_group(dev)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                         global_batch=8)
    fns = {}
    for bits in (32, 8):
        run = RunConfig(model=cfg, shape=ShapeConfig(256, 8),
                        optimizer=OptimizerConfig(compressor=Compressor(
                            gamma=0.01, method="block_topk",
                            value_bits=bits)))
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(0).items()}
        params, state, _ = train_step(params, state, batch, run)
        batch = {k: v.to(dev) for k, v in pipe.batch(1).items()}
        _, grads = value_and_grad(
            lambda p, b=batch: lm.loss_fn(p, b, cfg), params)
        smask = lm.stacked_mask(params)

        def exchange(g=grads, st=state, c=run.optimizer.compressor,
                     sm=smask):
            return worker_compress_aggregate(g, st.memory, 0.0345, c,
                                             stacked_mask=sm)

        def step(p=params, st=state, b=batch, r=run):
            return train_step(p, st, b, r)
        fns[f"exchange {bits}-bit"] = exchange
        fns[f"step {bits}-bit"] = step
    if guards_disabled is not None:
        def unguarded(fn):
            def call():
                with guards_disabled():
                    return fn()
            return call
        fns.update({f"{k} unguarded": unguarded(f)
                    for k, f in list(fns.items())})
    for _ in range(2):
        for fn in fns.values():
            fn()
    wall = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall[k].append((time.perf_counter() - t0) * 1e3)
    device = {}
    for k, fn in fns.items():
        if not k.startswith("exchange"):
            continue
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize(dev)
        device[k] = sum(getattr(e, "self_device_time_total", 0)
                        for e in prof.key_averages()) / 10 / 1e3
    if created:
        torch.distributed.destroy_process_group()
    return {"median_ms": {k: statistics.median(v) for k, v in wall.items()},
            "wall_ms": wall, "device_ms": device}


def _card() -> str:
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    return "nvidia-smi not available"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout's root (repeat; indexed from 0)")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree indices, one process each "
                         "(default: each tree once, in the given order)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None, help="write the results here")
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in args.tree]
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(trees))))
    out = {"card": _card(), "trees": [str(t) for t in trees],
           "order": order, "reps": args.reps, "runs": []}
    print(f"card: {out['card']}", flush=True)
    for i in order:
        env = dict(os.environ, PYTHONPATH=str(trees[i] / "src"))
        res = subprocess.run(
            [sys.executable, "-c", _WORKER, str(Path(__file__).resolve()),
             str(args.reps)], cwd=trees[i], env=env, capture_output=True,
            text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"tree {i} ({trees[i]}) failed with "
                             f"{res.returncode}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["tree"] = i
        out["runs"].append(run)
        print(f"tree {i}: median ms "
              + json.dumps({k: round(v, 3)
                            for k, v in run["median_ms"].items()})
              + "; exchange device ms "
              + json.dumps({k: round(v, 3)
                            for k, v in run["device_ms"].items()}),
              flush=True)
    # per tree, the median over its processes of each process's median
    summary = {}
    for i in sorted(set(order)):
        runs = [r for r in out["runs"] if r["tree"] == i]
        summary[i] = {k: statistics.median(r["median_ms"][k] for r in runs)
                      for k in runs[0]["median_ms"]}
    out["summary_ms"] = summary
    if len(summary) >= 2:
        base, new = summary[min(summary)], summary[max(summary)]
        out["ratio_to_first"] = {
            k: new[k] / base[k.replace(" unguarded", "")] for k in new
            if k.replace(" unguarded", "") in base}
        print("tree %d / tree %d, median of process medians: %s" % (
            max(summary), min(summary), json.dumps(
                {k: round(v, 4) for k, v in out["ratio_to_first"].items()})),
            flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
elif __name__ == "worker":
    print(json.dumps(_measure(int(sys.argv[2]))), flush=True)
