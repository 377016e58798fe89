"""rray_tpu_torch/utils/timing.py on the CPU (perf_counter clock):
rray_tpu's contracts for repeat_with_jitter, device_seconds_per_call and
measure_frame_seconds, on workloads whose time is known."""
import time

import pytest
import torch

from rray_tpu_torch.utils import timing


def test_repeat_with_jitter_consumes_its_jitter():
    """The thunk sums render_scalar(i * 1e-3) over i < reps: each call
    gets its own jitter, so a workload that reads it sums to another
    value than one that does not."""
    seen = []

    def render_scalar(jitter):
        seen.append(jitter)
        return torch.tensor(1.0) + jitter

    thunk = timing.repeat_with_jitter(render_scalar, 3)
    assert float(thunk()) == pytest.approx(3.003)
    assert seen == pytest.approx([0.0, 1e-3, 2e-3])
    flat = timing.repeat_with_jitter(lambda jitter: torch.tensor(1.0), 3)
    assert float(flat()) == 3.0 != float(thunk())


def test_device_seconds_per_call_is_the_slope():
    """A workload that sleeps 10 ms per repetition, behind a fixed 20 ms
    cost per thunk call: the slope between 1 and n reps is the 10 ms
    (sleep overshoots, never undershoots), not the fixed cost."""
    def make_fn(reps):
        def thunk():
            time.sleep(0.02)
            for _ in range(reps):
                time.sleep(0.01)
            return torch.tensor(float(reps))
        return thunk

    per_call = timing.device_seconds_per_call(make_fn, n=5, tries=2)
    assert 0.009 <= per_call < 0.02


def test_measure_frame_seconds_times_slow_frames_alone():
    """A frame over 1 s is timed by itself (best of 3 after a warm-up),
    without the repetition probe."""
    calls = []

    def render_scalar(jitter):
        calls.append(jitter)
        time.sleep(1.05)
        return torch.tensor(jitter)

    seconds = timing.measure_frame_seconds(render_scalar)
    assert 1.05 <= seconds < 1.6
    assert len(calls) == 4
