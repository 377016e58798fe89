"""ctypes bindings for the C++ host runtime (io/csrc/rray_host.cpp).

The reference's host runtime is native Rust (tobj, the `image` crate);
ours is C++ behind a C ABI: single-pass OBJ parsing to flat arrays, PNG
encoding, and the canvas quantization cast. The source is the package's
own copy of rray_tpu's `native/rray_host.cpp` (the same bytes), shipped
as package data; g++ compiles it at first use into the build directory
of the CUDA kernels (`build/rray_tpu_torch/`, named by a hash of the
source and flags). Every caller has a pure-Python fallback, so a
missing toolchain only costs speed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..kernels.build import BUILD_DIR

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "rray_host.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC")


def host_library_path(src: str, flags, stem: str) -> str:
    """`build/rray_tpu_torch/lib<stem>_<hash>.so`, named by a hash of the
    flags and the source."""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_host_library(src: str, flags, stem: str) -> str:
    """The path of a host library built by g++ from one C++ source with
    `flags`, linked against zlib; built first if it is not there."""
    so = host_library_path(src, flags, stem)
    if os.path.exists(so):
        return so
    # Build beside the target and rename: a process loading the library
    # must never see a half-written file.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *flags, "-o", tmp, src, "-lz"], check=True,
                   capture_output=True)
    os.replace(tmp, so)
    return so


def library_path() -> str:
    return host_library_path(_SRC, _FLAGS, "rray_host")


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("RRAY_NO_NATIVE") == "1":
            return None
        try:
            lib = ctypes.CDLL(build_host_library(_SRC, _FLAGS, "rray_host"))
        except Exception:
            return None

        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.obj_error.restype = ctypes.c_char_p
        lib.obj_error.argtypes = [ctypes.c_void_p]
        for name in ("obj_num_vertices", "obj_num_normals",
                     "obj_num_triangles", "obj_num_meshes"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        for name, typ in (("obj_positions", ctypes.c_double),
                          ("obj_normals", ctypes.c_double),
                          ("obj_tri_vertex", ctypes.c_int64),
                          ("obj_tri_normal", ctypes.c_int64),
                          ("obj_mesh_offsets", ctypes.c_int64)):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(typ)
            fn.argtypes = [ctypes.c_void_p]
        lib.obj_free.argtypes = [ctypes.c_void_p]

        lib.png_encode.restype = ctypes.c_int64
        lib.png_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.png_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]

        lib.quantize_rgba.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
        return _LIB


def parse_obj_native(text: str):
    """Parse OBJ text -> (positions[N,3], normals[M,3], tri_vertex[T,3],
    tri_normal[T,3], mesh_tri_offsets[list]) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode()
    handle = lib.obj_parse(data, len(data))
    try:
        err = lib.obj_error(handle)
        if err:
            raise ValueError(f"OBJ parse error: {err.decode()}")
        nv = lib.obj_num_vertices(handle)
        nn = lib.obj_num_normals(handle)
        nt = lib.obj_num_triangles(handle)
        nm = lib.obj_num_meshes(handle)
        as_np = np.ctypeslib.as_array
        positions = as_np(lib.obj_positions(handle), (nv, 3)).copy() \
            if nv else np.zeros((0, 3))
        normals = as_np(lib.obj_normals(handle), (nn, 3)).copy() \
            if nn else np.zeros((0, 3))
        tri_v = as_np(lib.obj_tri_vertex(handle), (nt, 3)).copy() \
            if nt else np.zeros((0, 3), np.int64)
        tri_n = as_np(lib.obj_tri_normal(handle), (nt, 3)).copy() \
            if nt else np.zeros((0, 3), np.int64)
        offsets = as_np(lib.obj_mesh_offsets(handle), (nm,)).copy().tolist() \
            if nm else []
        return positions, normals, tri_v, tri_n, offsets
    finally:
        lib.obj_free(handle)


def encode_png_native(rgba: np.ndarray) -> bytes | None:
    """RGBA8 [H,W,4] -> PNG bytes, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.png_encode(rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       w, h, ctypes.byref(out))
    if n < 0:
        return None
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.png_free(out)


def quantize_native(rgb: np.ndarray) -> np.ndarray | None:
    """float32 RGB [H,W,3] -> RGBA8 [H,W,4] via the native truncating cast."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    lib.quantize_rgba(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      h * w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
