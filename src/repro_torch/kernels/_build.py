"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in ``.gitignore``).  The library's file name
carries a hash of its source and flags, so an edited source is rebuilt on
first use and an unchanged one is loaded as it is.  Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("ef_topk", "wire_pack", "flash_attention",
           "flash_attention_sm90", "rmsnorm", "rwkv_wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each exported launcher: pointers and the stream as void*,
# so ctypes never truncates a 64-bit address to a 32-bit int
SIGNATURES = {
    "ef_topk": {
        "ef_stats_telemetry_launch": (_P, _P, _P, _P, _P, _LL, _I, _P),
        "ef_block_stats_launch": (_P, _P, _P, _P, _LL, _I, _P),
        "block_stats_launch": (_P, _P, _LL, _I, _P),
        "ef_apply_launch": (_P, _P, _P, _P, _P, _P, _LL, _P),
        "threshold_split_launch": (_P, _P, _P, _P, _LL, _P),
    },
    "wire_pack": {
        "pack_words_launch": (_P, _P, _P, _LL, _LL, _I, _I, _P),
        "unpack_words_launch": (_P, _P, _P, _LL, _LL, _I, _I, _P),
    },
    "flash_attention": {
        "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _P),
    },
    "flash_attention_sm90": {
        "flash_attention_sm90_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _F, _I, _I, _P),
        "flash_attention_sm90_smem_bytes": (_I,),
    },
    "rmsnorm": {
        "rmsnorm_launch": (_P, _P, _P, _LL, _I, _F, _I, _I, _P),
    },
    "rwkv_wkv": {
        "wkv_forward_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _P),
        "wkv_forward_smem_bytes": (_I,),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns the
    wall seconds of each build (0.0 when the library existed).  Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees a
                               # half-written library
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build (``-Xptxas -v`` register
    and spill report), or '' when the library was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher reports a CUDA error (its cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    return raw_stream(t.get_device())


def raw_stream(device_index: int) -> int:
    """The handle of the current CUDA stream on a device, read through
    the raw getter that PyTorch's own Triton launchers use:
    ``torch.cuda.current_stream`` builds a Stream object first, about ten
    times the host time, and serving's decode is bound by the host's
    launches."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_no_grad(name: str, *ts: torch.Tensor) -> None:
    """Raise when an input needs a gradient: the serving kernels, like the
    TPU kernels they replace, have no backward, so they must never sit
    silently inside autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: the kernel is forward-only and an "
                           "input requires a gradient (run under "
                           "torch.inference_mode() or torch.no_grad())")
