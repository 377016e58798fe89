"""Build and load the CUDA kernels from this package's sources.

The kernels are compiled by `nvcc` into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers). Each unit (a .cu
file and its macro definitions; whitted.cu makes five) compiles to an
object in its own `nvcc` process, all started together, and one more
`nvcc` links them.
The library lands in `build/rray_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads the cached file. Nothing is downloaded and no
package of finished kernels is used.

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
# (source, macro definitions): whitted.cu's stage-e kernels, the bulk of
# the build, compile in four more units (csrc/whitted.cu RRAY_EXT_UNIT).
_UNITS = (("whitted.cu", ()),
          *(("whitted.cu", (f"-DRRAY_EXT_UNIT={u}",)) for u in (1, 2, 3, 4)),
          ("triangles.cu", ()), ("bvh.cu", ()), ("area.cu", ()),
          ("downsample.cu", ()), ("deflate.cu", ()))
_SOURCES = ("whitted.cu", "triangles.cu", "bvh.cu", "area.cu",
            "downsample.cu", "deflate.cu", "vec_device.cuh",
            "mesh_device.cuh", "whitted_device.cuh", "jitter_device.cuh",
            "quartic_device.cuh", "noise_device.cuh", "stage_device.cuh",
            "downsample_device.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "rray_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
# The one lock of the kernel modules' counters (launches, table and tree
# builds): over a local mesh (parallel/mesh.py) the wrappers run on
# several threads at once, and `n += 1` is a read, an add and a write.
COUNT_LOCK = threading.Lock()
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
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(_UNITS)).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librray_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> str:
    """Compile every unit in parallel, link, and return nvcc's output."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for k, (unit, defines) in enumerate(_UNITS):
        obj = f"{tmp}.{k}.{unit}.o"
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj,
               os.path.join(_CSRC, unit)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(f"{tmp}.so", path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def count(namespace: dict, name: str):
    """Add one to the counter `name` of a kernel module (its globals())
    under COUNT_LOCK."""
    with COUNT_LOCK:
        namespace[name] += 1


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
        ints = ctypes.POINTER(i32)
        lib.whitted_compact_launch.argtypes = (
            [ptr] * 9 + [ptr, ints, ptr, ptr] + [i32] * 4 + [ints, ptr])
        lib.whitted_blocks_per_sm.restype = i32
        lib.whitted_blocks_per_sm.argtypes = [i32] * 4
        lib.closest_triangle_launch.restype = i32
        lib.closest_triangle_launch.argtypes = (
            [ptr] * 8 + [i32] * 4 + [ptr] + [i32] * 3
            + [ptr, ptr, i32, i32, ptr, ptr])
        lib.any_triangle_launch.restype = i32
        lib.any_triangle_launch.argtypes = (
            [ptr] * 8 + [i32] * 4 + [ptr, i32, i32, ptr, ptr])
        lib.bvh_closest_launch.restype = i32
        lib.bvh_closest_launch.argtypes = (
            [ptr] * 7 + [ptr] + [i32] * 6 + [ptr] + [i32] * 3
            + [ptr, ptr, i32, i32, ptr, ptr])
        lib.area_shadow_launch.restype = i32
        lib.area_shadow_launch.argtypes = (
            [ptr] * 7 + [i32] * 3 + [ptr, i32, ptr])
        lib.downsample_launch.restype = i32
        lib.downsample_launch.argtypes = [ptr, ptr] + [i32] * 5 + [ptr]
        lib.png_quantize_launch.restype = i32
        lib.png_quantize_launch.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.deflate_match_launch.restype = i32
        lib.deflate_match_launch.argtypes = [ptr, ptr, i32] + [ptr] * 5
        lib.whitted_error_string.restype = ctypes.c_char_p
        lib.whitted_error_string.argtypes = [i32]
        _LIB = lib
        return _LIB


def error_string(code: int) -> str:
    return load_library().whitted_error_string(code).decode()


def ptr(t):
    """A tensor's device pointer for a c_void_p argument (None: a null
    pointer)."""
    return None if t is None else t.data_ptr()


def stream(device):
    """PyTorch's current CUDA stream on `device`, for a c_void_p
    argument."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def device_guard(device):
    """The context in which to launch on `device`: torch.cuda.device,
    unless `device` is current already (the check costs less than
    switching)."""
    import contextlib

    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_arg(name, t, shape, device, dtype=None):
    """Refuse what a kernel does not take: another device, a dtype other
    than `dtype` (float32 by default), another shape, a strided tensor."""
    import torch

    dtype = dtype or torch.float32
    if (t.device == device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the CUDA kernel takes "
                        f"{dtype} only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_launch(kernel: str, rc: int):
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({error_string(rc)})")
