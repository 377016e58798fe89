"""The PNG of an image that lies on the card: its deflate matches are
searched there (kernels/deflate.py), and the host emitter
(io/csrc/png_deflate.cpp, in a library of its own) turns the tables into
compress2(..., 6)'s bytes, the same PNG that render/canvas.py::write_png
writes from a host copy.

g++ compiles the emitter at first use into the build directory of the
CUDA kernels (`build/rray_tpu_torch/librray_deflate_<hash>.so`), linked
against the host's zlib, whose adler32() and crc32() it calls. There is
no fallback: an image on the card is written by this path or not at all.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..kernels import deflate
from ..utils import profiling
from .native import build_host_library

_LOCK = threading.Lock()
_LIB = None

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "png_deflate.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")


def get_lib():
    """Load (building if needed) the emitter's library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = build_host_library(_SRC, _FLAGS, "rray_deflate")
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_deflate_encode.restype = ctypes.c_int64
        lib.png_deflate_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(u8p)]
        lib.png_deflate_free.argtypes = [u8p]
        lib.png_deflate_zlib_version.restype = ctypes.c_char_p
        lib.png_deflate_zlib_version.argtypes = []
        _LIB = lib
        return _LIB


def zlib_version() -> str:
    """The version of the zlib that the emitter links."""
    return get_lib().png_deflate_zlib_version().decode()


def _pinned(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class _Buffers:
    """Pinned host buffers for the copies from the card, reused from
    frame to frame: the stream's grown to the largest stream, the listed
    rows' to the most rows."""

    def __init__(self):
        self.lock = threading.Lock()
        self.n = self.m = 0

    def get(self, n: int):
        if n > self.n:
            self.raw = _pinned(n, dtype=torch.uint8)
            self.table = _pinned(n)
            self.directory = _pinned(deflate.slabs(n), 2)
            self.count = _pinned(1)
            self.n = n
        return self

    def rows_for(self, m: int):
        if m >= self.m:  # the first call too: self.m starts at 0
            self.m = m + 1
            self.rows = _pinned(self.m, 2)
        return self.rows[:m]


_BUFFERS = _Buffers()


def encode(raw: np.ndarray, table: np.ndarray, rows: np.ndarray,
           directory: np.ndarray, width: int, height: int) -> bytes:
    """PNG bytes of the raw stream from its match tables (numpy views of
    kernels/deflate.py's outputs; `rows` holds at least every row that
    `directory` names)."""
    n = raw.size
    if n != deflate.raw_size(height, width):
        raise ValueError(f"{n} raw bytes for a {width}x{height} image")
    if table.size != n or directory.shape != (deflate.slabs(n), 2):
        raise ValueError("the tables are not the stream's")
    if directory.size and int((directory[:, 0] + directory[:, 1]).max()) > \
            rows.shape[0]:
        raise ValueError("the directory names rows past the listed ones")
    arrays = [np.ascontiguousarray(a) for a in (raw, table, rows, directory)]
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = lib.png_deflate_encode(
        arrays[0].ctypes.data, n, arrays[1].ctypes.data,
        arrays[2].ctypes.data, arrays[3].ctypes.data, width, height,
        ctypes.byref(out))
    if size < 0:
        raise RuntimeError("png_deflate_encode refused the tables")
    try:
        return ctypes.string_at(out, size)
    finally:
        lib.png_deflate_free(out)


def png_bytes(image) -> bytes:
    """[h, w, 3] float image, a CUDA or a CPU tensor -> the PNG bytes
    that canvas.write_png writes of its host copy. The tables are made
    where the image lies (`rray.png_tables`: on the card, its work, the
    copy into pinned buffers and the wait), then the host emits the
    stream (`rray.deflate`)."""
    h, w = image.shape[:2]
    n = deflate.raw_size(h, w)
    with _BUFFERS.lock:
        with profiling.span("png_tables"):
            tables = deflate.match_tables(image)
            if image.device.type == "cuda":
                bufs = _BUFFERS.get(n)
                host = (bufs.raw[:n], bufs.table[:n], None,
                        bufs.directory[:deflate.slabs(n)], bufs.count)
                for i in (0, 1, 3, 4):
                    host[i].copy_(tables[i], non_blocking=True)
                torch.cuda.current_stream(image.device).synchronize()
                rows = bufs.rows_for(int(bufs.count[0]))
                rows.copy_(tables[2][:rows.shape[0]])
                tables = (host[0], host[1], rows, host[3])
        with profiling.span("deflate"):
            return encode(*(t.numpy() for t in tables[:4]), w, h)


def write_png(path: str, image) -> None:
    """Write the PNG of an image that lies on the card (or, in the CPU
    tests, a CPU tensor, through the plain version)."""
    with profiling.span("png"):
        png = png_bytes(image)
        with open(path, "wb") as f:
            f.write(png)
