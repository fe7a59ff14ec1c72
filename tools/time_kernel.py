#!/usr/bin/env python3
"""Time a CUDA kernel of the port against other versions of its source on
one card.

    python3 tools/time_kernel.py KERNEL [--extra path/to/source.cu ...]

KERNEL is ``block_stats``, ``ef_stats_telemetry`` or ``ef_block_stats``
(``csrc/ef_topk.cu``), ``wkv_forward`` (``csrc/rwkv_wkv.cu``), or
``pack_words`` or ``unpack_words`` (``csrc/wire_pack.cu``).  Builds
the kernel's source in ``src/repro_torch/csrc/`` and each ``--extra``
source (an older commit's, unpacked with ``git archive``, say) with the
port's own nvcc flags, all at once, into the gitignored
``src/repro_torch/_build/compare/``, and prints
ptxas's registers and spills of every kernel each build holds.  Checks
each build against the kernel's plain version in
``repro_torch.kernels.ref`` at every case, and the library call and the
port's wrapper, where the kernel has them, too; then times each at the
timed cases in turns (the builds in order, then in reverse) with
``chip_smoke.py``'s three clocks: the median of 25 calls between CUDA
events, host launch included (``ms``), the device time alone from the
profiler (``device``), and the host's time a call over 1,000
back-to-back calls without a synchronize (``host``; the device's time
where the device is the slower); the library call that computes the
same function, where there is one, and the port's wrapper, where it is
set, are timed in the same turns.  Prints, for each ``--extra``
build, whether its outputs are bit-identical to this source's at every
case.  Calls the builds through a bare ctypes launcher, without the
wrapper's checks.  Prints the card's name and power limit.

Cases.  ``block_stats``: the largest CSGD leaf of paper-lm-100m, (18432,
1024) f32 Gaussian x 1e-2, at k_b 10, 41 and 102 (gamma 1%, 4% and 10%;
timed, beside ``torch.topk``), and the edge rows of ``chip_smoke.py``
(NaN, +-inf, zeros, ties) at k_b 1, 10 and 1024; bit-exact, NaN where the
plain version gives NaN.  ``ef_stats_telemetry`` and ``ef_block_stats``:
the trainer's 107,520 block rows of paper-lm-100m, m ~ N(0, 1e-3),
g ~ N(0, 1e-2), eta 0.0345, at k_b 10, 41 and 102 (timed), and the edge
rows as g with m = 0 and eta 0.5 at k_b 1, 10 and 1024; tau bit-exact
(NaN where the plain version gives NaN), the moments within 8 ulp.
``wkv_forward``: rwkv6-1.6b's prefill (4, 1024, 32, 64) and a decode
step (S = 1), both timed, and a ragged (2, 65, 3, 32) with V = 100; atol
2e-5 on y and sT.  ``pack_words`` and ``unpack_words``: the trainer's
16-bit index streams at k_b 10, 41 and 102 (537,600, 2,204,160 and
5,483,520 words) and its 8-bit value stream at k_b 10 (268,800 words),
as paper-lm-100m's bucket plan packs them (per layer row, so no word is
padded per 1024-block), each in the (rows, 512)-word layout of
``ops.pack_fields_stream``, timed beside the narrowing cast that
computes the same function (``chip_smoke.cast_pack``:
``x.to(int16).view(int32)``, ``cast_unpack``: ``x.view(uint16).to(
int32)``; int8 and uint8 at 8 bits); checked only: 4-bit fields, the
ragged variant at period 11 (16-bit) and 29 (4-bit), the input's base
one word off (16 and 8 bits) and a stream whose length is no multiple
of 4 words; random int32 bit patterns, bit-exact.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import cast_pack, cast_unpack, device_ms, host_ms, \
    special_rows, time_ms  # noqa: E402
from repro_torch.kernels import _build, ref, wire_pack  # noqa: E402

OUT = _build.BUILD_DIR / "compare"


@dataclass(frozen=True)
class Kernel:
    source: str                   # csrc/<source>.cu
    entry: str                    # its C launcher
    cases: dict                   # case -> the arguments of ``inputs``
    timed: tuple                  # the cases timed
    inputs: Callable              # (generator, device, *case) -> inputs
    launch: Callable              # (C launcher, *inputs) -> outputs
    plain: Callable               # *inputs -> outputs
    error: Callable               # (got, want) -> a float, 0 if equal
    tol: float
    library: Callable | None = None   # *inputs -> outputs, timed cases
    wrapper: Callable | None = None   # the port's own call, *inputs


def _bs_inputs(gen, device, rows, k_b, kind):
    if kind == "edge":
        return special_rows(device)[:rows], k_b
    return torch.randn((rows, 1024), generator=gen, device=device) * 1e-2, \
        k_b


def _bs_launch(fn, x, k_b):
    tau = torch.empty((x.shape[0], 1), device=x.device)
    _check(fn(x.data_ptr(), tau.data_ptr(), x.shape[0], k_b,
              _build.stream(x)))
    return tau


def _bs_error(got, want) -> float:
    """The number of rows that differ (NaN equals NaN)."""
    return float(((got != want) & ~(got.isnan() & want.isnan())).sum())


def _ef_inputs(gen, device, rows, k_b, kind):
    if kind == "edge":
        g = special_rows(device)[:rows]
        return torch.zeros_like(g), g, torch.tensor([0.5], device=device), \
            k_b
    m = torch.randn((rows, 1024), generator=gen, device=device) * 1e-3
    g = torch.randn((rows, 1024), generator=gen, device=device) * 1e-2
    return m, g, torch.tensor([0.0345], device=device), k_b


def _ef_launch(fn, m, g, eta, k_b, moments=True):
    R = m.shape[0]
    tau = torch.empty((R, 1), device=m.device)
    if not moments:
        _check(fn(m.data_ptr(), g.data_ptr(), eta.data_ptr(),
                  tau.data_ptr(), R, k_b, _build.stream(m)))
        return tau
    mom = torch.empty((R, 2), device=m.device)
    _check(fn(m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
              mom.data_ptr(), R, k_b, _build.stream(m)))
    return tau, mom


def _ef_error(got, want) -> float:
    """inf if a row's tau differs (NaN equals NaN), else the moments'
    largest distance in ulps (non-finite moments must be equal, NaN
    where the plain version has NaN)."""
    (tau, mom), (rtau, rmom) = got, want
    if _bs_error(tau, rtau):
        return float("inf")
    fin = rmom.isfinite()
    if _bs_error(mom[~fin], rmom[~fin]):
        return float("inf")
    a, b = (t[fin].view(torch.int32).long() for t in (mom, rmom))
    return float((a - b).abs().max()) if a.numel() else 0.0


def _wkv_inputs(gen, device, B, S, H, K, V):
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale
    return (randn(B, S, H, K, scale=0.3), randn(B, S, H, K, scale=0.3),
            randn(B, S, H, V), torch.sigmoid(randn(B, S, H, K)),
            randn(H, K, scale=0.1), randn(B, H, K, V, scale=0.1))


def _wkv_launch(fn, r, k, v, w, u, s0):
    B, S, H, K = r.shape
    V = v.shape[3]
    y = torch.empty((B, S, H, V), device=r.device)
    sT = torch.empty((B, H, K, V), device=r.device)
    _check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
              B, S, H, K, V, _build.stream(r)))
    return y, sT


def _wkv_error(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def _wire_inputs(gen, device, rows, cols, bits, period, offset, pack):
    """(x, bits, counts, period): (rows, cols) words or their fields,
    random int32 patterns, the base ``offset`` words into a buffer."""
    F = 32 // bits if pack else 1
    buf = torch.randint(-2**31, 2**31 - 1, ((offset + rows * cols) * F,),
                        generator=gen, device=device, dtype=torch.int32)
    counts = torch.randint(0, period + 1, (rows,), generator=gen,
                           device=device, dtype=torch.int32) \
        if period else None
    return buf[offset * F:].view(rows, cols * F), bits, counts, period


def _wire_launch(fn, x, bits, counts, period, pack=True):
    R, n = x.shape
    W = n // (32 // bits) if pack else n
    out = torch.empty((R, W if pack else n * (32 // bits)),
                      dtype=torch.int32, device=x.device)
    _check(fn(x.data_ptr(), 0 if counts is None else counts.data_ptr(),
              out.data_ptr(), R, W, bits, period, _build.stream(x)))
    return out


def _wire_error(got, want) -> float:
    """The number of fields or words that differ."""
    return float((got != want).sum())


def _wire_kernel(pack: bool) -> Kernel:
    """pack_words or unpack_words: the trainer's streams in the (rows,
    512)-word layout of ``ops.pack_fields_stream``, then the edges."""
    def stream(words, bits):
        return (*wire_pack.stream_shape(words), bits, 0, 0, pack)
    cases = {"k10": stream(537_600, 16), "k41": stream(2_204_160, 16),
             "k102": stream(5_483_520, 16), "v8": stream(268_800, 8),
             "b4": (33, 100, 4, 0, 0, pack),
             "ragged11": (97, 40, 16, 11, 0, pack),
             "ragged29": (9, 40, 4, 29, 0, pack),
             "head16": (5, 203, 16, 0, 1, pack),
             "head8": (5, 203, 8, 0, 1, pack),
             "tail": (5, 203, 16, 0, 0, pack)}
    if pack:
        return Kernel(
            "wire_pack", "pack_words_launch", cases,
            ("k10", "k41", "k102", "v8"), _wire_inputs, _wire_launch,
            ref.pack_fields, _wire_error, 0.0,
            library=lambda x, bits, c, p: cast_pack(x, bits),
            wrapper=wire_pack.pack_words)
    return Kernel(
        "wire_pack", "unpack_words_launch", cases,
        ("k10", "k41", "k102", "v8"), _wire_inputs,
        lambda fn, *a: _wire_launch(fn, *a, pack=False),
        ref.unpack_fields, _wire_error, 0.0,
        library=lambda x, bits, c, p: cast_unpack(x, bits),
        wrapper=wire_pack.unpack_words)


#: the trainer's block rows at the paper's 1%, 4% and 10%, and edge rows
_EF_CASES = {"k10": (107520, 10, "gauss"), "k41": (107520, 41, "gauss"),
             "k102": (107520, 102, "gauss"), "edge1": (8, 1, "edge"),
             "edge10": (8, 10, "edge"), "edge1024": (8, 1024, "edge")}

KERNELS = {
    "block_stats": Kernel(
        "ef_topk", "block_stats_launch",
        {"k10": (18432, 10, "gauss"), "k41": (18432, 41, "gauss"),
         "k102": (18432, 102, "gauss"), "edge1": (8, 1, "edge"),
         "edge10": (8, 10, "edge"), "edge1024": (8, 1024, "edge")},
        ("k10", "k41", "k102"), _bs_inputs, _bs_launch,
        ref.block_abs_topk_threshold, _bs_error, 0.0,
        library=lambda x, k_b: torch.topk(x.abs(), k_b, dim=1).values[
            :, -1:]),
    "ef_stats_telemetry": Kernel(
        "ef_topk", "ef_stats_telemetry_launch", _EF_CASES,
        ("k10", "k41", "k102"), _ef_inputs, _ef_launch,
        ref.ef_block_stats_telemetry, _ef_error, 8.0),
    "ef_block_stats": Kernel(
        "ef_topk", "ef_block_stats_launch", _EF_CASES,
        ("k10", "k41", "k102"), _ef_inputs,
        lambda fn, *a: _ef_launch(fn, *a, moments=False),
        ref.ef_block_stats, _bs_error, 0.0),
    "wkv_forward": Kernel(
        "rwkv_wkv", "wkv_forward_launch",
        {"prefill": (4, 1024, 32, 64, 64), "decode": (4, 1, 32, 64, 64),
         "ragged": (2, 65, 3, 32, 100)},
        ("prefill", "decode"), _wkv_inputs, _wkv_launch,
        ref.wkv_reference, _wkv_error, 2e-5),
    "pack_words": _wire_kernel(pack=True),
    "unpack_words": _wire_kernel(pack=False),
}


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--extra", nargs="*", default=[],
                    help="other versions of the kernel's source")
    return ap.parse_args(argv)


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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")


def launcher(kernel: Kernel, name: str) -> Callable:
    fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), kernel.entry)
    fn.argtypes = _build.SIGNATURES[kernel.source][kernel.entry]
    fn.restype = ctypes.c_int
    return lambda *a: kernel.launch(fn, *a)


def check(kernel: Kernel, name: str, call: Callable, data: dict,
          want: dict) -> str:
    """Hold ``call`` against the plain outputs ``want`` at every case;
    raise SystemExit beyond the kernel's tolerance, else return a line
    of the errors."""
    errs = []
    for case, args in data.items():
        e = kernel.error(call(*args), want[case])
        if not e <= kernel.tol:
            raise SystemExit(f"{name} at {case} is {e} from the plain "
                             f"version (tol {kernel.tol})")
        errs.append(f"{case} {e:.2e}")
    return f"check {name}: {', '.join(errs)}"


def _bits(out) -> list[torch.Tensor]:
    return [t.view(torch.int32) for t in
            (out if isinstance(out, tuple) else (out,))]


def identical(name: str, call: Callable, this: Callable, data: dict) -> str:
    """A line saying whether ``call``'s outputs are bit-identical to
    ``this``'s at every case, or at which cases they are not."""
    differ = [case for case, args in data.items()
              if not all(torch.equal(a, b) for a, b in
                         zip(_bits(call(*args)), _bits(this(*args))))]
    return f"bits {name} vs this: " + (
        f"differ at {', '.join(differ)}" if differ
        else "identical at every case")


def main(argv=None) -> None:
    args = parse_args(argv)
    kernel = KERNELS[args.kernel]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sources = {"this": _build.CSRC / f"{kernel.source}.cu"}
    for i, path in enumerate(args.extra):
        sources[f"extra{i}"] = Path(path).resolve()
        print(f"extra{i}: {path}")
    build_all(sources)

    gen = torch.Generator(device="cuda").manual_seed(16)
    data = {case: kernel.inputs(gen, "cuda", *c)
            for case, c in kernel.cases.items()}
    want = {case: kernel.plain(*a) for case, a in data.items()}
    calls = {name: launcher(kernel, name) for name in sources}
    for name, call in calls.items():
        print(check(kernel, name, call, data, want), flush=True)
        if name != "this":
            print(identical(name, call, calls["this"], data), flush=True)
    if kernel.library is not None:
        timed = {case: data[case] for case in kernel.timed}
        print(check(kernel, "library", kernel.library, timed, want),
              flush=True)
        calls["library"] = kernel.library
    if kernel.wrapper is not None:
        print(check(kernel, "wrapper", kernel.wrapper, data, want),
              flush=True)
        calls["wrapper"] = kernel.wrapper
    times = {(name, case, how): [] for name in calls for case in kernel.timed
             for how in ("ms", "device", "host")}
    for name in list(calls) + list(reversed(calls)):
        for case in kernel.timed:
            call = lambda: calls[name](*data[case])  # noqa: E731
            times[name, case, "ms"].append(time_ms(call))
            times[name, case, "device"].append(device_ms(call))
            times[name, case, "host"].append(host_ms(call))
    for (name, case, how), t in times.items():
        print(f"time {name} {case} {kernel.cases[case]} {how}: "
              f"{' '.join(f'{x:.4f}' for x in t)} ms", flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
