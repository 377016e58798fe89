"""Arithmetic of the measured window and of the device timeline.

A rate or a time per item is the whole window's wall time over the items
completed in it, never a median of chunks, so a stall anywhere in the
window moves it. A tail is taken over every item of the window.
"""
from __future__ import annotations

import math


def per_item_ms(starts, ends) -> float | None:
    """The window's wall time, from the first item's start to the last
    item's end, over the items, in ms."""
    if not ends:
        return None
    return 1e3 * (ends[-1] - starts[0]) / len(ends)


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merged(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def gaps(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
