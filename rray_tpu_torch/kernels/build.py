"""Build and load the CUDA kernels from this package's sources.

The kernels are compiled by `nvcc` into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in `build/rray_tpu_torch/` at
the repository root, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads the cached file.
Nothing is downloaded and no package of finished kernels is used.

Flags: sm_90a (Hopper), -O3, and --fmad=false so that the kernels round
every product and sum separately, as their plain PyTorch versions do.
Never -use_fast_math.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_SOURCES = ("whitted.cu", "whitted_device.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "rray_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
# What the last load did: {"path", "cache_hit", "seconds", "log"}.
last_build: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librray_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "whitted.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return proc.stdout + proc.stderr


def load_library():
    """The kernels' ctypes library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        t0 = time.perf_counter()
        hit = os.path.exists(path)
        log = "" if hit else _compile(path)
        lib = ctypes.CDLL(path)
        last_build.update(path=path, cache_hit=hit, log=log,
                          seconds=time.perf_counter() - t0)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.whitted_compact_launch.restype = i32
        lib.whitted_compact_launch.argtypes = (
            [ptr] * 9 + [ptr, i32, ptr, i32, ptr, i32, ptr]
            + [i32] * 5 + [ptr])
        lib.whitted_error_string.restype = ctypes.c_char_p
        lib.whitted_error_string.argtypes = [i32]
        _LIB = lib
        return _LIB


def error_string(code: int) -> str:
    return load_library().whitted_error_string(code).decode()
