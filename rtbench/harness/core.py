"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

A runner (runners/<name>.py, named by the cell's traffic mix) does the
cell's own work through six names:

    UNIT                        "frame" or "step": what one item is
    SPANS                       (module path, attribute, span name) that
                                a traced run wraps with host spans
    setup(run) -> state         load, build and warm up every shape the
                                window uses (load_libraries(run) first;
                                time that the reference takes in set-up
                                goes into run.reference_s, which setup_s
                                leaves out)
    close(state)                remove what set-up wrote
    step(state, i)              one item through the port's user entry,
                                finished on the card when it returns
    check(state) -> {name: number}
                                the correctness numbers, each compared
                                with its limit in limits/<cell>.json
                                (lower is better: a number passes when it
                                is at most its limit)
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import os
import sys
import time
import traceback

from . import trace as trace_mod
from . import window
from .registry import Registry
from .spans import Spans

# Top-level module names that may not be loaded in a run's process: JAX,
# the JAX package and its benchmark (bench.py, benchmarks/).
FORBIDDEN = ("jax", "jaxlib", "flax", "rray_tpu", "bench", "benchmarks")


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    registry: Registry
    unit: str = ""
    setup_s: float = 0.0
    starts: list = dataclasses.field(default_factory=list)
    ends: list = dataclasses.field(default_factory=list)
    failed: int = 0
    errors: list = dataclasses.field(default_factory=list)
    built: list = dataclasses.field(default_factory=list)
    load_s: float = 0.0
    reference_s: float = 0.0
    spans: Spans | None = None
    timeline: trace_mod.Trace | None = None
    step_peaks: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name, compared whole,
    is JAX's or the JAX package's ("rray_tpu_torch" is not "rray_tpu")."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_libraries(run, host: bool = True):
    """Load the port's CUDA kernel library (on a card) and, with `host`,
    its host library, as the first frame would. A checkout's first run
    builds them (nvcc, g++); run.built names what this process built and
    run.load_s is the seconds the loads took, so that run's set-up can be
    told apart."""
    from rray_tpu_torch.io import native
    from rray_tpu_torch.kernels import build

    t0 = time.perf_counter()
    if run.device.startswith("cuda"):
        build.load_library()
        if not build.last_build.get("cache_hit", True):
            run.built.append("kernels")
    if host:
        had = os.path.exists(native.library_path())
        if native.get_lib() is not None and not had:
            run.built.append("host")
    run.load_s = time.perf_counter() - t0


def _resolve(path: str):
    mod, _, attr = path.rpartition(":")
    return importlib.import_module(mod), attr


def read_counters(paths) -> dict:
    """The program's counters, each a "module:attribute" path."""
    return {path: getattr(*_resolve(path)) for path in paths}


def _window(run: Run, runner, state, torch, cuda: bool, counters=()):
    """Items back to back until `run.seconds` have passed; each item's
    start and end on the host clock, and what each of the program's
    `counters` counted from right before the first item to right after
    the last (run.counts). A traced run wraps the runner's spans,
    profiles the card, and reads each step's peak memory."""
    seconds = run.seconds
    spans = run.spans

    def item(i):
        if run.trace and cuda:
            torch.cuda.reset_peak_memory_stats()
        s = time.perf_counter()
        try:
            if spans is not None:
                with spans.span(runner.UNIT):
                    runner.step(state, i)
            else:
                runner.step(state, i)
        except Exception:  # counted: a failed item is an answer that never comes
            run.failed += 1
            if len(run.errors) < 3:
                run.errors.append(traceback.format_exc())
        e = time.perf_counter()
        if run.trace and cuda:
            run.step_peaks.append(torch.cuda.max_memory_allocated())
        run.starts.append(s)
        run.ends.append(e)
        return e

    before = read_counters(counters)
    t0 = time.perf_counter()
    i = 0
    while item(i) - t0 < seconds:
        i += 1
    after = read_counters(counters)
    run.counts = {path: after[path] - before[path] for path in counters}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", registry: Registry | None = None,
             overrides: dict | None = None, t_start: float | None = None):
    """-> (result dict, checks [(name, value, limit)]). `overrides`
    changes configuration and mix keys ({"config": {...}, "mix": {...}}),
    for tests at small sizes on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    registry = registry or Registry()
    cell = registry.cell(name)
    overrides = overrides or {}
    config = {**registry.config(cell["config"]), **overrides.get("config", {})}
    mix = {**registry.mix(cell["traffic"]), **overrides.get("mix", {})}
    limits = registry.limits(name)
    runner = registry.runner(mix["runner"])
    run = Run(name, config, mix, seed, seconds, trace, device, registry,
              unit=runner.UNIT)

    import torch

    cuda = device.startswith("cuda")
    counters = registry.counters(name)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = runner.setup(run)
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start - run.reference_s

    if trace:
        run.spans = Spans(torch, sync=cuda)
        targets = [(*_resolve(path), span) for path, span in runner.SPANS]
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with run.spans.around(targets), \
                torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(
                    trace_mod.PREFIX + trace_mod.WINDOW):
                _window(run, runner, state, torch, cuda, counters)
            if cuda:
                torch.cuda.synchronize()
        run.timeline = trace_mod.from_profiler(prof)
    else:
        _window(run, runner, state, torch, cuda, counters)

    peak = max(run.step_peaks) if run.step_peaks else (
        torch.cuda.max_memory_allocated() if cuda else 0)

    try:
        numbers = runner.check(state)
    finally:
        runner.close(state)
    checks = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    correct = (run.failed == 0 and bool(run.ends)
               and all(v <= lim for _, v, lim in checks))  # NaN fails

    metrics = {}
    for m in registry.metrics_for(name, trace):
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.ends),
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.timeline is not None:
        dev["busy_s"] = run.timeline.busy_s()
        dev["window_s"] = run.timeline.window_s
        result["breakdown"] = {"device_ops": run.timeline.top_ops(),
                               "idle_gaps": run.timeline.idle_gaps()}
    # What set-up held besides loading and warming up: the builds of a
    # checkout's first run (setup_s counts them), the reference's share
    # (setup_s leaves it out).
    result["set_up"] = {"built": list(run.built), "load_s": run.load_s,
                        "reference_s": run.reference_s}
    # A number that is not finite has failed; JSON has no NaN, so null.
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, v, lim in checks}
    for err in run.errors:
        print(err, file=sys.stderr)
    if run.built:
        print(f"rtbench: this run built {', '.join(run.built)}; loading "
              f"took {run.load_s:.3f} s of setup_s", file=sys.stderr)
    if run.ends:
        ms = sorted(1e3 * (e - s) for s, e in zip(run.starts, run.ends))
        q = [window.percentile(ms, p) for p in (5, 50, 95)]
        print(f"rtbench: {len(ms)} {run.unit}s, ms per {run.unit}: p5 "
              f"{q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} max {ms[-1]:.3f}",
              file=sys.stderr)
    return result, checks
