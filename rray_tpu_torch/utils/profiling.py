"""Profiling hooks (rray_tpu utils/profiling.py) over torch.profiler.

`with trace("/path/to/dir"): render(...)` records the host and, where
CUDA is available, the card's kernels, and writes a Chrome trace
(`<host>_<pid>.<time>.pt.trace.json`, viewable in chrome://tracing,
Perfetto or TensorBoard) into the directory; `live_arrays_bytes()`
reports the device memory that tensors hold.
"""
from __future__ import annotations

import contextlib
import os

import torch


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
