"""What the metric readers share: items of the window, span totals per
item, the program's own ranges and counters per item, and which device
rows are the port's own CUDA kernels."""
from __future__ import annotations

import re

# The __global__ functions of rray_tpu_torch/kernels/csrc/*.cu.
PORT_KERNEL = re.compile(
    r"\b(whitted_kernel|closest_kernel|any_kernel|bvh_kernel|"
    r"bvh_staged_kernel|area_kernel)\b")


def items(run, unit: str) -> int:
    """The window's items if they are of `unit` ("frame", "step"), else 0."""
    return len(run.ends) if run.unit == unit else 0


def span_ms(run, unit: str, *names) -> float | None:
    """The spans `names` summed, in ms per item of `unit` (None outside a
    traced run, or where no such span was recorded)."""
    n = items(run, unit)
    if not n or run.spans is None:
        return None
    if not any(name in run.spans.seconds for name in names):
        return None
    return 1e3 * sum(run.spans.total(name) for name in names) / n


def program_ms(run, unit: str, *names) -> float | None:
    """The program's ranges `names` ("png" for rray.png) that start
    inside the traced window, summed, in ms per item of `unit`: None
    outside a traced run or where the window holds no rray.frame range,
    0 where its frames hold none of `names`."""
    n = items(run, unit)
    if not n or run.timeline is None:
        return None
    tl = run.timeline
    inside = [(s, e, name) for s, e, name in tl.program if tl.lo <= s < tl.hi]
    if not any(name == "frame" for _, _, name in inside):
        return None
    return 1e3 * sum(e - s for s, e, name in inside if name in names) / n


def count_per_item(run, unit: str, path: str) -> float | None:
    """What the program's counter `path` ("module:attribute", declared in
    the metric's COUNTERS) counted over the window, per item of `unit`
    (None where it was not read)."""
    n = items(run, unit)
    if not n or path not in run.counts:
        return None
    return run.counts[path] / n


def kernel_ms(run, unit: str) -> float | None:
    """Device time of the port's kernels per item; None where none ran."""
    n = items(run, unit)
    if not n or run.timeline is None:
        return None
    if not any(PORT_KERNEL.search(name)
               for name in run.timeline.seconds_by_name):
        return None
    return 1e3 * run.timeline.device_seconds(
        lambda name: PORT_KERNEL.search(name) is not None) / n


def idle_pct(run, unit: str) -> float | None:
    if not items(run, unit) or run.timeline is None:
        return None
    return run.timeline.idle_pct()
