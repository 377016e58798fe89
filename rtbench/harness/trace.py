"""The traced run's device timeline, from torch.profiler (CUPTI).

Only the profiler's own rows are read: the card's kernels, copies and
sets with their start and end, the "rtbench.*" ranges that the
benchmark's spans mark on the host, and the "rray.*" ranges that the
program's own spans mark there (rray_tpu_torch/utils/profiling.py).
The trace stays in memory; nothing is exported to disk.
"""
from __future__ import annotations

import dataclasses
import functools

from . import window

PREFIX = "rtbench."
PROGRAM_PREFIX = "rray."


@dataclasses.dataclass
class Trace:
    """Times in seconds on the profiler's clock. A traced Adam window
    holds millions of rows, so the union of the rows and their time per
    name are worked out once and shared by the readers."""

    device: list        # (start, end, name): work on the card
    notes: list         # (start, end, span name): the benchmark's ranges
    lo: float           # the traced window
    hi: float
    # (start, end, span name): the program's ranges, "rray." taken off
    program: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @functools.cached_property
    def busy(self) -> list:
        """The union of the device rows within the window, as sorted
        disjoint intervals."""
        return window.merged([(s, e) for s, e, _ in self.device],
                             self.lo, self.hi)

    @functools.cached_property
    def seconds_by_name(self) -> dict:
        """Device seconds within the window per row name (the sum of the
        rows: one kernel's rows never overlap)."""
        by = {}
        for s, e, n in self.device:
            if e > self.lo and s < self.hi:
                by[n] = by.get(n, 0.0) + min(e, self.hi) - max(s, self.lo)
        return by

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def idle_pct(self) -> float | None:
        if self.hi <= self.lo:
            return None
        return 100.0 * (1.0 - self.busy_s() / (self.hi - self.lo))

    def device_seconds(self, match) -> float:
        """Device time of the rows whose name `match` accepts."""
        return sum(v for n, v in self.seconds_by_name.items() if match(n))

    def top_ops(self, k: int = 10):
        by = {}
        for n, v in self.seconds_by_name.items():
            by[short(n)] = by.get(short(n), 0.0) + v
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle seconds of the card summed by the innermost benchmark span
        open on the host at each gap's midpoint ("outside spans" where
        none is)."""
        notes = sorted(self.notes, key=lambda r: (r[0], -r[1]))
        by = {}
        for s, e in window.gaps(self.busy, self.lo, self.hi):
            mid = 0.5 * (s + e)
            name, width = "outside spans", None
            for a, b, n in notes:
                if a <= mid < b and (width is None or b - a < width):
                    name, width = n, b - a
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]


def short(name: str) -> str:
    """A device row's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip() or name


WINDOW = "window"


def from_profiler(prof) -> Trace:
    """A Trace from a finished torch.profiler.profile. The traced window
    is the "rtbench.window" range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, notes, program = [], [], []
    events = prof.profiler.kineto_results.events()
    # Seconds from the first row, so that a float keeps the nanoseconds.
    base = events[0].start_ns() if events else 0

    def span(ev):
        s = (ev.start_ns() - base) * 1e-9
        return s, s + ev.duration_ns() * 1e-9

    # Most rows are the host's ops: ask each only what tells it apart.
    for ev in events:
        if ev.is_user_annotation():  # a range, on the host or the card
            if ev.device_type() != cuda:
                name = ev.name()
                if name.startswith(PREFIX):
                    notes.append((*span(ev), name[len(PREFIX):]))
                elif name.startswith(PROGRAM_PREFIX):
                    program.append((*span(ev),
                                    name[len(PROGRAM_PREFIX):]))
        elif ev.device_type() == cuda:
            device.append((*span(ev), ev.name()))
    spans = [(s, e) for s, e, n in notes if n == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {PREFIX}{WINDOW} range")
    lo, hi = spans[0]
    return Trace(device, [r for r in notes if r[2] != WINDOW], lo, hi,
                 program)
