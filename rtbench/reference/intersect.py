# Frozen copy of rray_tpu_torch/ops/intersect.py at commit 6dfcb62 (imports made local).
"""Batched, masked ray/primitive intersection on [R, 3] rays (rray_tpu
ops/intersect.py, the port's own): the per-ray (AoS) formulation.

Each reference `local_intersect` (sphere.rs:64-78, plane.rs:51-58,
cube.rs:65-77, cylinder.rs:94-123, cone.rs:120-166, torus.rs:36-93,
triangle.rs:72-94) is a closed-form evaluation over [R rays, N
primitives] returning fixed hit slots (t, valid). Branches are masks;
divisions are guarded so invalid lanes stay NaN-free. These are plain
torch ops on whatever device the rays live on: the reference path of
ops/hits.py, written apart from the SoA slots of ops/soa.py and from the
CUDA kernels, so that it can check them.
"""
from __future__ import annotations

import torch

from .rconfig import EPSILON
from . import quartic

_BIG = 1e30


def _full(like, value):
    """`value` in the dtype and on the device of `like` (a bare Python
    number in torch.where takes the default dtype, float32)."""
    return torch.full_like(like, value)


def _safe_div(a, b, eps=1e-30):
    e = _full(b, eps)
    denom = torch.where(torch.abs(b) < eps, torch.where(b < 0, -e, e), b)
    return a / denom


def affine(m, v, point: bool):
    """m [..., 3, 4] applied to vectors v [..., 3] (broadcast over the
    leading axes) -> [..., 3]: x m0 + y m1 + z m2 (+ m3 for a point), in
    that order of operations, as the routed nodes and the kernels apply
    an affine (ops/vec.py affine_point). In float32 the torus quartic
    turns an ulp of its object-space ray into ~1e-3 of a root, so the
    order is what keeps the two formulations' rays the same."""
    out = (m[..., 0] * v[..., None, 0] + m[..., 1] * v[..., None, 1]
           + m[..., 2] * v[..., None, 2])
    return out + m[..., 3] if point else out


def transform_rays(inv, ro, rd):
    """Apply world->object affines [N, 3, 4] to rays [R, 3] -> the
    object-space pair, [R, N, 3] each."""
    return (affine(inv[None], ro[:, None, :], True),
            affine(inv[None], rd[:, None, :], False))


def spheres(ro, rd):
    """Unit sphere at the origin (sphere.rs:64-78). 2 slots."""
    a = torch.sum(rd * rd, -1)
    b = 2.0 * torch.sum(rd * ro, -1)
    c = torch.sum(ro * ro, -1) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = _safe_div(torch.ones_like(a), 2.0 * a)
    t = torch.stack([(-b - sq) * inv2a, (-b + sq) * inv2a], -1)
    return t, torch.stack([ok, ok], -1)


def planes(ro, rd):
    """The xz-plane (plane.rs:51-58). 1 slot."""
    dy = rd[..., 1]
    ok = torch.abs(dy) >= EPSILON
    t = _safe_div(-ro[..., 1], dy)
    return t[..., None], ok[..., None]


def _slab(o, d, lo=-1.0, hi=1.0):
    """One axis of the cube's slab test with the reference's infinity
    semantics (cube.rs:48-61): a parallel ray inside the slab spans
    (-inf, inf), one outside it spans nothing."""
    num_min = lo - o
    num_max = hi - o
    parallel = torch.abs(d) < EPSILON
    t1 = _safe_div(num_min, d)
    t2 = _safe_div(num_max, d)
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    inside = (num_min <= 0.0) & (num_max >= 0.0)
    big = _full(o, _BIG)
    tmin = torch.where(parallel, torch.where(inside, -big, big), tmin)
    tmax = torch.where(parallel, torch.where(inside, big, -big), tmax)
    return tmin, tmax


def cubes(ro, rd):
    """The unit cube (cube.rs:65-77). 2 slots."""
    xmin, xmax = _slab(ro[..., 0], rd[..., 0])
    ymin, ymax = _slab(ro[..., 1], rd[..., 1])
    zmin, zmax = _slab(ro[..., 2], rd[..., 2])
    tmin = torch.maximum(xmin, torch.maximum(ymin, zmin))
    tmax = torch.minimum(xmax, torch.minimum(ymax, zmax))
    ok = tmin <= tmax
    return torch.stack([tmin, tmax], -1), torch.stack([ok, ok], -1)


def _caps(ro, rd, ymin, ymax, closed, cap_radius_fn):
    """The shared cap test (cylinder.rs:60-90, cone.rs:60-96). 2 slots."""
    dy = rd[..., 1]
    cap_possible = closed & (torch.abs(dy) >= EPSILON)
    t_lo = _safe_div(ymin - ro[..., 1], dy)
    t_hi = _safe_div(ymax - ro[..., 1], dy)

    def at(t):
        x = ro[..., 0] + t * rd[..., 0]
        z = ro[..., 2] + t * rd[..., 2]
        y = ro[..., 1] + t * rd[..., 1]
        return x * x + z * z <= cap_radius_fn(y)

    ok_lo = cap_possible & at(t_lo)
    ok_hi = cap_possible & at(t_hi)
    return torch.stack([t_lo, t_hi], -1), torch.stack([ok_lo, ok_hi], -1)


def cylinders(ro, rd, ymin, ymax, closed):
    """The truncated cylinder (cylinder.rs:94-123). 4 slots: the body's
    two, then the caps."""
    ox, oy, oz = ro[..., 0], ro[..., 1], ro[..., 2]
    dx, dy, dz = rd[..., 0], rd[..., 1], rd[..., 2]
    a = dx * dx + dz * dz
    body_possible = torch.abs(a) > EPSILON
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    ok = body_possible & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = _safe_div(torch.ones_like(a), 2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    y0 = oy + lo * dy
    y1 = oy + hi * dy
    ok0 = ok & (ymin < y0) & (y0 < ymax)
    ok1 = ok & (ymin < y1) & (y1 < ymax)
    # Reference quirk (cylinder.rs:101-102): a negative discriminant
    # returns [] outright, dropping the caps too.
    miss_all = body_possible & (disc < 0.0)
    tc, vc = _caps(ro, rd, ymin, ymax, closed, torch.ones_like)
    vc = vc & ~miss_all[..., None]
    t = torch.cat([torch.stack([lo, hi], -1), tc], -1)
    valid = torch.cat([torch.stack([ok0, ok1], -1), vc], -1)
    return t, valid


def cones(ro, rd, ymin, ymax, closed):
    """The double-napped truncated cone (cone.rs:120-166). 5 slots: the
    linear t, the body's two, the caps; with the reference's early
    returns (a linear hit inside the y range returns without caps)."""
    ox, oy, oz = ro[..., 0], ro[..., 1], ro[..., 2]
    dx, dy, dz = rd[..., 0], rd[..., 1], rd[..., 2]
    a = dx * dx - dy * dy + dz * dz
    b = 2.0 * (ox * dx - oy * dy + oz * dz)
    c = ox * ox - oy * oy + oz * oz
    a_small = torch.abs(a) < EPSILON
    b_small = torch.abs(b) < EPSILON

    # Linear branch (cone.rs:134-141).
    t_lin = _safe_div(-c, 2.0 * b)
    y_lin = oy + t_lin * dy
    lin_hit = a_small & ~b_small & (ymin < y_lin) & (y_lin < ymax)

    # Quadratic branch (also reached with a tiny `a` when the linear hit
    # is out of range; its huge t values fail the y test).
    disc = b * b - 4.0 * a * c
    quad_path = ~(a_small & b_small) & ~lin_hit
    okq = quad_path & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = _safe_div(torch.ones_like(a), 2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    y0 = oy + lo * dy
    y1 = oy + hi * dy
    ok0 = okq & (ymin < y0) & (y0 < ymax)
    ok1 = okq & (ymin < y1) & (y1 < ymax)
    # disc < 0 on the quadratic path returns [] before the caps
    # (cone.rs:143-146).
    miss_all = quad_path & (disc < 0.0)

    tc, vc = _caps(ro, rd, ymin, ymax, closed, lambda y: y * y)
    vc = vc & ~lin_hit[..., None] & ~miss_all[..., None]
    t = torch.cat([t_lin[..., None], torch.stack([lo, hi], -1), tc], -1)
    valid = torch.cat([lin_hit[..., None], torch.stack([ok0, ok1], -1), vc],
                      -1)
    return t, valid


def _enters_torus_box(ro, rd, minor_r):
    """Does the object-space ray enter the torus's box (x, y in
    [-(1 + r), 1 + r], z in [-r, r]), padded by 1e-3 so that the test is
    conservative? A ray that does not provably misses the torus."""
    half = torch.stack(torch.broadcast_tensors(
        1.0 + minor_r + 1e-3, 1.0 + minor_r + 1e-3, minor_r + 1e-3), -1)
    inv = _safe_div(torch.ones_like(rd), rd)
    t1 = (-half - ro) * inv
    t2 = (half - ro) * inv
    tmin = torch.amax(torch.minimum(t1, t2), -1)
    tmax = torch.amin(torch.maximum(t1, t2), -1)
    return (tmin <= tmax) & (tmax >= 0.0)


def tori(ro, rd, minor_r):
    """The torus of major radius 1 about the z axis (torus.rs:36-93). 4
    slots; only roots t > 0 count, as in the reference, and only on rays
    that enter the torus's box: no other ray can hit it, but in float32
    the quartic of a far origin is ill-conditioned enough to report
    roots for some (rray_tpu's SoA slots gate on the same box)."""
    ox, oy, oz = ro[..., 0], ro[..., 1], ro[..., 2]
    dx, dy, dz = rd[..., 0], rd[..., 1], rd[..., 2]
    r_sq = minor_r * minor_r
    sum_d_sq = dx * dx + dy * dy + dz * dz
    e = ox * ox + oy * oy + oz * oz - r_sq + 1.0
    f = ox * dx + oy * dy + oz * dz
    four = 4.0
    a4 = sum_d_sq * sum_d_sq
    a3 = 4.0 * sum_d_sq * f
    a2 = 2.0 * sum_d_sq * e + 4.0 * f * f - four * (dx * dx + dy * dy)
    a1 = 4.0 * e * f - 2.0 * four * (ox * dx + oy * dy)
    a0 = e * e - four * (ox * ox + oy * oy)
    roots, ok = quartic.solve_quartic(a4, a3, a2, a1, a0)
    enter = _enters_torus_box(ro, rd, minor_r)
    return roots, ok & (roots > 0.0) & enter[..., None]


def triangles(ro, rd, p1, e1, e2):
    """Möller–Trumbore (triangle.rs:72-94) on world-space rays [R, 3]
    and triangles [T, 3] -> t, u, v, valid, each [R, T]."""
    d = rd[:, None, :]
    dce2 = torch.linalg.cross(d.expand(-1, e2.shape[0], -1),
                              e2[None, :, :].expand(d.shape[0], -1, -1))
    det = torch.sum(e1[None, :, :] * dce2, -1)
    ok = torch.abs(det) >= EPSILON
    fct = _safe_div(torch.ones_like(det), det)
    p1o = ro[:, None, :] - p1[None, :, :]
    u = fct * torch.sum(p1o * dce2, -1)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    oce1 = torch.linalg.cross(p1o, e1[None, :, :].expand_as(p1o))
    v = fct * torch.sum(d * oce1, -1)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = fct * torch.sum(e2[None, :, :] * oce1, -1)
    return t, u, v, ok
