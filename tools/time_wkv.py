#!/usr/bin/env python3
"""Time the WKV kernel against other versions of its source on one card.

    python3 tools/time_wkv.py [--extra path/to/rwkv_wkv.cu ...]

Builds ``src/repro_torch/csrc/rwkv_wkv.cu`` and each ``--extra`` source
(an older commit's, say, unpacked with ``git archive``) with the port's
own nvcc flags, all at once, into the gitignored
``src/repro_torch/_build/compare/``.  Each build is checked against
``repro_torch.kernels.ref.wkv_reference`` (atol 2e-5 on y and sT) at
rwkv6-1.6b's prefill (4, 1024, 32, 64), a decode step (S = 1) and a
ragged case (2, 65, 3, 32) with V = 100, then timed at the prefill and
the decode shape in turns (the builds in order, then in reverse) with
``chip_smoke.py``'s two clocks: the median of 25 calls between CUDA
events, host launch included, and the device time alone from the
profiler.  Calls the kernels through a bare
ctypes launcher, without the wrapper's checks.  Prints ptxas's
registers and spills and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import device_ms, time_ms  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

OUT = _build.BUILD_DIR / "compare"
SHAPES = {"prefill": (4, 1024, 32, 64, 64), "decode": (4, 1, 32, 64, 64),
          "ragged": (2, 65, 3, 32, 100)}


def build_all(sources: dict[str, Path]) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, src in sources.items()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def launcher(name: str):
    fn = ctypes.CDLL(str(OUT / f"{name}.so")).wkv_forward_launch
    fn.argtypes = _build.SIGNATURES["rwkv_wkv"]["wkv_forward_launch"]
    fn.restype = ctypes.c_int

    def call(r, k, v, w, u, s0):
        B, S, H, K = r.shape
        V = v.shape[3]
        y = torch.empty((B, S, H, V), device=r.device)
        sT = torch.empty((B, H, K, V), device=r.device)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                 B, S, H, K, V, _build.stream(r))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return y, sT
    return call


def inputs(gen, B, S, H, K, V):
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    return (randn(B, S, H, K, scale=0.3), randn(B, S, H, K, scale=0.3),
            randn(B, S, H, V), torch.sigmoid(randn(B, S, H, K)),
            randn(H, K, scale=0.1), randn(B, H, K, V, scale=0.1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extra", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sources = {"this": _build.CSRC / "rwkv_wkv.cu"}
    for i, path in enumerate(args.extra):
        sources[f"extra{i}"] = Path(path).resolve()
        print(f"extra{i}: {path}")
    build_all(sources)

    gen = torch.Generator(device="cuda").manual_seed(16)
    data = {key: inputs(gen, *s) for key, s in SHAPES.items()}
    want = {key: ref.wkv_reference(*a) for key, a in data.items()}
    calls = {name: launcher(name) for name in sources}
    for name, fn in calls.items():
        errs = []
        for key, a in data.items():
            y, sT = fn(*a)
            e = max(float((y - want[key][0]).abs().max()),
                    float((sT - want[key][1]).abs().max()))
            errs.append(f"{key} {e:.2e}")
            if not e <= 2e-5:
                raise SystemExit(f"{name} at {key} {SHAPES[key]} is {e} from "
                                 "the plain version (atol 2e-5)")
        print(f"check {name}: {', '.join(errs)}", flush=True)
    times = {(name, key, how): [] for name in calls
             for key in ("prefill", "decode") for how in ("ms", "device")}
    for name in list(calls) + list(reversed(calls)):
        for key in ("prefill", "decode"):
            call = lambda: calls[name](*data[key])  # noqa: E731
            times[name, key, "ms"].append(time_ms(call))
            times[name, key, "device"].append(device_ms(call))
    for (name, key, how), t in times.items():
        print(f"time {name} {key} {SHAPES[key][:4]} {how}: "
              f"{' '.join(f'{x:.4f}' for x in t)} ms", flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
