"""Analytic hit slots on SoA rays (the subset of rray_tpu ops/soa.py that
the Whitted kernel's plain version needs).

Each function takes object-space rays as V3 component tensors and
returns the prim's hit slots as a list of (t, valid) pairs. The formulas
are rray_tpu's, quirks included: the cylinder's negative discriminant
drops its caps too (cylinder.rs:101-102), the cone's linear case returns
early (cone.rs:134-141), and every EPSILON guard sits where the reference
has it (sphere.rs:64-78, plane.rs:51-58, cube.rs:48-77). The CUDA kernel
(kernels/csrc/whitted.cu) writes the same expressions in the same order.

Per-prim scalars (ymin, ymax, closed) are Python numbers.
"""
from __future__ import annotations

import torch

from ..config import EPSILON
from .vec import V3


def _sphere_slots(o: V3, d: V3):
    a = d.dot(d)
    b = 2.0 * d.dot(o)
    c = o.dot(o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 1e-30))
    inv2a = 0.5 / a  # |d| > 0 for camera/shadow rays
    return [((-b - sq) * inv2a, ok), ((-b + sq) * inv2a, ok)]


def _plane_slots(o: V3, d: V3):
    ok = torch.abs(d.y) >= EPSILON
    t = -o.y / torch.where(ok, d.y, 1.0)
    return [(t, ok)]


def _cube_slots(o: V3, d: V3):
    big = torch.full_like(o.x, 1e30)

    def axis(oc, dc):
        parallel = torch.abs(dc) < EPSILON
        dsafe = torch.where(parallel, 1.0, dc)
        t1 = (-1.0 - oc) / dsafe
        t2 = (1.0 - oc) / dsafe
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        inside = (oc >= -1.0) & (oc <= 1.0)
        lo = torch.where(parallel, torch.where(inside, -big, big), lo)
        hi = torch.where(parallel, torch.where(inside, big, -big), hi)
        return lo, hi

    xlo, xhi = axis(o.x, d.x)
    ylo, yhi = axis(o.y, d.y)
    zlo, zhi = axis(o.z, d.z)
    tmin = torch.maximum(xlo, torch.maximum(ylo, zlo))
    tmax = torch.minimum(xhi, torch.minimum(yhi, zhi))
    ok = tmin <= tmax
    return [(tmin, ok), (tmax, ok)]


def _cap_slots(o: V3, d: V3, ymin, ymax, closed, cone: bool):
    steep = torch.abs(d.y) >= EPSILON
    cap_possible = steep & bool(closed)
    dsafe = torch.where(steep, d.y, 1.0)
    out = []
    for bound in (ymin, ymax):
        t = (bound - o.y) / dsafe
        x = o.x + t * d.x
        z = o.z + t * d.z
        if cone:
            y = o.y + t * d.y
            radius = y * y
        else:
            radius = 1.0
        out.append((t, cap_possible & (x * x + z * z <= radius)))
    return out


def _cylinder_slots(o: V3, d: V3, ymin, ymax, closed):
    a = d.x * d.x + d.z * d.z
    body_possible = torch.abs(a) > EPSILON
    b = 2.0 * (o.x * d.x + o.z * d.z)
    c = o.x * o.x + o.z * o.z - 1.0
    disc = b * b - 4.0 * a * c
    ok = body_possible & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 1e-30))
    inv2a = 0.5 / torch.where(body_possible, a, 1.0)
    lo = (-b - sq) * inv2a
    hi = (-b + sq) * inv2a
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    y0 = o.y + lo * d.y
    y1 = o.y + hi * d.y
    slots = [(lo, ok & (ymin < y0) & (y0 < ymax)),
             (hi, ok & (ymin < y1) & (y1 < ymax))]
    # Negative discriminant returns [] outright, dropping caps too
    # (cylinder.rs:101-102).
    miss_all = body_possible & (disc < 0.0)
    for t, valid in _cap_slots(o, d, ymin, ymax, closed, cone=False):
        slots.append((t, valid & ~miss_all))
    return slots


def _cone_slots(o: V3, d: V3, ymin, ymax, closed):
    a = d.x * d.x - d.y * d.y + d.z * d.z
    b = 2.0 * (o.x * d.x - o.y * d.y + o.z * d.z)
    c = o.x * o.x - o.y * o.y + o.z * o.z
    a_small = torch.abs(a) < EPSILON
    b_small = torch.abs(b) < EPSILON

    t_lin = -c / torch.where(b_small, 1.0, 2.0 * b)
    y_lin = o.y + t_lin * d.y
    lin_hit = a_small & ~b_small & (ymin < y_lin) & (y_lin < ymax)

    disc = b * b - 4.0 * a * c
    quad_path = ~(a_small & b_small) & ~lin_hit
    okq = quad_path & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 1e-30))
    eps = torch.full_like(a, EPSILON)
    eps = torch.where(a < 0, -eps, eps)
    inv2a = 0.5 / torch.where(a_small, eps, a)
    lo = (-b - sq) * inv2a
    hi = (-b + sq) * inv2a
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    y0 = o.y + lo * d.y
    y1 = o.y + hi * d.y
    slots = [(t_lin, lin_hit),
             (lo, okq & (ymin < y0) & (y0 < ymax)),
             (hi, okq & (ymin < y1) & (y1 < ymax))]
    miss_all = quad_path & (disc < 0.0)
    for t, valid in _cap_slots(o, d, ymin, ymax, closed, cone=True):
        slots.append((t, valid & ~lin_hit & ~miss_all))
    return slots


def _sphere_occludes_local(o: V3, d: V3, dist):
    """Root of the unit-sphere quadratic in [0, dist)? sqrt/div-free sign
    tests on b, c, f(dist) and b + 2a*dist (rray_tpu soa.py:1313)."""
    a = d.dot(d)
    b = 2.0 * d.dot(o)
    c = o.dot(o) - 1.0
    ok = b * b - 4.0 * a * c >= 0.0  # real roots
    fd = (a * dist + b) * dist + c   # f(dist)
    s2 = b + 2.0 * a * dist
    tm_in = (b <= 0.0) & (c >= 0.0) & ((s2 > 0.0) | (fd < 0.0))
    tp_in = ((b <= 0.0) | (c <= 0.0)) & (s2 > 0.0) & (fd > 0.0)
    return ok & (tm_in | tp_in)


def _plane_occludes_local(o: V3, d: V3, dist):
    """xz-plane crossing in [0, dist)? The t = -oy/dy range test
    multiplied through by dy^2 — no divide."""
    oy_dy = o.y * d.y
    return ((torch.abs(d.y) >= EPSILON) & (oy_dy <= 0.0)
            & (-oy_dy < dist * d.y * d.y))
