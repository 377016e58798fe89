"""Host spans around the calls into the port's layers, recorded by the
benchmark itself in a traced run.

A span wraps a name that a module of the port looks up when it calls
(api.load_scene_file, api.render, train.render_loss), synchronizes the
card before and after, so that it holds the device work it started,
and marks the same interval as a `torch.profiler.record_function` range
named "rtbench.<span>", which the trace's reader uses to name the idle
gaps of the device's timeline.
"""
from __future__ import annotations

import contextlib
import time


class Spans:
    """Durations in seconds by span name, in the order recorded."""

    def __init__(self, torch, sync: bool = True):
        self.torch = torch
        self.sync = sync and torch.cuda.is_available()
        self.seconds = {}

    def _sync(self):
        if self.sync:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        with self.torch.profiler.record_function(f"rtbench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def wrapped(self, fn, name: str):
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call

    @contextlib.contextmanager
    def around(self, targets):
        """Wrap each (module, attribute, span name) of `targets` for the
        duration of the block; the originals come back after it."""
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
        try:
            for (mod, attr, name), (_, _, fn) in zip(targets, saved):
                setattr(mod, attr, self.wrapped(fn, name))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def total(self, name: str) -> float:
        return sum(self.seconds.get(name, ()))
