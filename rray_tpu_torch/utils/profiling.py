"""Profiling hooks (rray_tpu utils/profiling.py) over torch.profiler.

`with trace("/path/to/dir"): render(...)` records the host and, where
CUDA is available, the card's kernels, and writes a Chrome trace
(`<host>_<pid>.<time>.pt.trace.json`, viewable in chrome://tracing,
Perfetto or TensorBoard) into the directory; `live_arrays_bytes()`
reports the device memory that tensors hold.

The program marks the layers of a CLI frame with `span(name)`: in a
trace they are host ranges named "rray.<name>" on the profiler's own
clock, beside the card's rows, so the card's idle gaps can be put down
to the host work open at the time:

    rray.frame       api.render_scene_from_file / _from_str /
                     render_scene_progressive, the whole call
    rray.load        io/yaml_loader.py: the YAML parsed into a scene
    rray.compile     scene/data.py::compile_scene
    rray.render      integrator.render_block: the rays, the route, the
                     tables and the launches, enqueued with no wait
    rray.tables      a per-scene kernel table packed (whitted, the
                     triangle kernels, the BVH tree)
    rray.copy        api.render_scene's image (downsampled on the card
                     where aa > 1) copied to the host, the wait for the
                     card's work included; a band's raster in
                     render/progressive.py
    rray.downsample  where aa > 1: api.render_scene's box filter on the
                     raster's device (on the card an enqueue with no
                     wait; kernels/downsample.py), and canvas.downsample
                     of a host canvas (render_scene_progressive, write_png)
    rray.png         the PNG: canvas.write_png of a host image (quantize,
                     compress2, write), or io/deflate.py::write_png of
                     an image on the card, which holds the next two and
                     the write
    rray.png_tables  the card's quantize and deflate match search
                     (kernels/deflate.py), the copy of the stream and its
                     tables into pinned buffers, and the wait for them
    rray.deflate     the host's lazy parse, Huffman blocks and
                     checksums over those tables (io/csrc/png_deflate.cpp)

With no profiler recording, a span is one flag check and a shared
no-op; it never synchronizes the card. An operator sees the spans by
tracing a frame; the Chrome trace holds them as `rray.*` ranges:

    with trace("/tmp/rray-trace"):
        api.render_scene_from_file("scene.yaml", 800, 600, "out.png")
"""
from __future__ import annotations

import contextlib
import os

import torch

PREFIX = "rray."

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `name` as the range "rray.<name>"
    while a torch.profiler profile records, and does nothing
    otherwise."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the with block (CPU activity, and CUDA
    activity when CUDA is available) and write a Chrome trace into
    `log_dir`; yields the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def live_arrays_bytes(device="cuda") -> int:
    """Bytes held by live tensors on a CUDA device (its caching
    allocator's count, torch.cuda.memory_allocated). Other devices keep
    no such count: they raise rather than report 0."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device {device!r} keeps no allocator count of "
                         "live tensors (only CUDA devices do)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested, but "
                           "torch.cuda.is_available() is False")
    return torch.cuda.memory_allocated(dev)

