"""Frame timing by repetition (rray_tpu utils/timing.py, the port's own),
with rray_tpu's names and contracts.

`repeat_with_jitter` builds a thunk that runs a workload `reps` times,
each time perturbed so that nothing can be reused between runs;
`device_seconds_per_call` times the thunk at 1 and at n repetitions and
returns the slope, the time of one run without the thunk's fixed cost;
`measure_frame_seconds` picks the repetition count for a frame, and
falls back to the time of one run above 1 s.

The clock follows the thunk's result: a CUDA tensor is timed by a pair
of CUDA events around the call (the device's time from the first launch
to the last kernel's end, after a synchronize), anything else by
`time.perf_counter` around the call and its conversion to a float.
"""
from __future__ import annotations

import time

import torch


def repeat_with_jitter(render_scalar, reps: int):
    """A thunk: the sum of `reps` evaluations render_scalar(i * 1e-3), i
    = 0 .. reps - 1. `render_scalar(jitter)` returns a scalar tensor and
    must consume `jitter` (e.g. feed it into the camera), so that no two
    evaluations are the same work."""
    def thunk():
        acc = 0.0
        for i in range(reps):
            acc = acc + render_scalar(i * 1e-3)
        return acc

    return thunk


def _seconds(fn, cuda: bool) -> float:
    """Seconds of one fn() call on the clock for its result's device."""
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3
    t0 = time.perf_counter()
    float(fn())
    return time.perf_counter() - t0


def _warm(fn) -> bool:
    """Call fn once (warm-up) -> whether its result lives on the card."""
    out = fn()
    cuda = torch.is_tensor(out) and out.is_cuda
    float(out)
    return cuda


def device_seconds_per_call(make_fn, n: int = 2001, tries: int = 4) -> float:
    """make_fn(reps) -> a zero-argument callable returning a scalar that
    runs the workload `reps` times. Returns the seconds of one run: the
    slope between the best of `tries` timings at 1 and at n reps."""
    t = {}
    for reps in (1, n):
        fn = make_fn(reps)
        cuda = _warm(fn)
        t[reps] = min(_seconds(fn, cuda) for _ in range(tries))
    return max((t[n] - t[1]) / (n - 1), 1e-9)


def measure_frame_seconds(render_scalar, max_exec_seconds: float = 4.0):
    """Seconds of one frame of `render_scalar` (see repeat_with_jitter).
    A frame slower than 1 s is timed alone (best of 3 after a warm-up);
    a faster one by device_seconds_per_call, its repetition count sized
    from a 16-rep probe so that one timed call lasts about
    `max_exec_seconds` (64 to 20001 reps)."""
    one = repeat_with_jitter(render_scalar, 1)
    cuda = _warm(one)
    best = min(_seconds(one, cuda) for _ in range(3))
    if best > 1.0:
        return best
    probe = device_seconds_per_call(
        lambda k: repeat_with_jitter(render_scalar, k), n=16, tries=2)
    est = max(probe, 1e-7)
    n = max(min(int(max_exec_seconds / est), 20001), 64)
    return device_seconds_per_call(
        lambda k: repeat_with_jitter(render_scalar, k), n=n)
