# Frozen copy of rray_tpu_torch/ops/normals.py at commit 6dfcb62 (imports made local).
"""Surface normals and UV mappings of a selected hit on [R, 3] points
(rray_tpu ops/normals.py, the port's own): the per-ray (AoS) forms.

`normal_at` mirrors the reference dispatch (object.rs:52-56): the world
point into object space through the composed inverse, the type's local
normal, then back through the composed inverse-transpose and
normalized. Triangles are stored in world space, so their normals come
from the triangle tables directly (smooth ones interpolate by u, v).

The UV mappings mirror each shape's uv_mapping (sphere.rs:126-132,
plane.rs:105-113, cube.rs:132-174, cylinder.rs:181-196, cone.rs:232-255,
torus.rs:150-161, triangle.rs:148-170) on pattern-space points, as
Texture patterns use them (pattern.rs:209-213). These are written apart
from render/shade_soa.py's SoA forms, which they check.
"""
from __future__ import annotations

import math

import torch

from .rconfig import EPSILON
from . import data as sd
from .intersect import affine
from .vec import div


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(n, 1e-30)


def _gather_rows(table, rows):
    if table.shape[0] == 0:
        return torch.zeros(rows.shape + table.shape[1:], dtype=table.dtype,
                           device=table.device)
    return table[torch.clamp(rows, 0, table.shape[0] - 1).long()]


def _stack3(x, y, z):
    return torch.stack([x, y, z], -1)


def local_point(scene: sd.SceneData, prim, world_pt):
    """world_to_object through the composed inverse (object.rs:102-109):
    [R, 3] world points of prims [R] -> [R, 3] object-space points."""
    return affine(scene.prim_inv[prim.long()], world_pt, True)


def normal_at(scene: sd.SceneData, prim, u, v, world_pt):
    """World-space unit normal at the hit, before the eye-facing flip."""
    prim = prim.long()
    ptype = scene.prim_type[prim]
    row = scene.prim_row[prim]
    lp = local_point(scene, prim, world_pt)
    x, y, z = lp[:, 0], lp[:, 1], lp[:, 2]
    present = set(_present_types(scene))
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)

    local_n = torch.zeros_like(lp)

    def merge(code, n):
        return torch.where((ptype == code)[:, None], n, local_n)

    def capped(cmin, cmax, dist, side):
        top = _stack3(zeros, ones, zeros)
        bot = _stack3(zeros, -ones, zeros)
        return torch.where(
            ((dist < 1.0) & (y >= cmax - EPSILON))[:, None], top,
            torch.where(((dist < 1.0) & (y <= cmin + EPSILON))[:, None],
                        bot, side))

    if sd.SPHERE in present:
        local_n = merge(sd.SPHERE, lp)
    if sd.PLANE in present:
        local_n = merge(sd.PLANE, _stack3(zeros, ones, zeros))
    if sd.CUBE in present:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        maxc = torch.maximum(ax, torch.maximum(ay, az))
        n = torch.where((maxc == ax)[:, None], _stack3(x, zeros, zeros),
                        torch.where((maxc == ay)[:, None],
                                    _stack3(zeros, y, zeros),
                                    _stack3(zeros, zeros, z)))
        local_n = merge(sd.CUBE, n)
    if sd.CYLINDER in present:
        n = capped(_gather_rows(scene.cyl_min, row),
                   _gather_rows(scene.cyl_max, row), x * x + z * z,
                   _stack3(x, zeros, z))
        local_n = merge(sd.CYLINDER, n)
    if sd.CONE in present:
        dist = x * x + z * z
        ny = torch.sqrt(torch.clamp_min(dist, 0.0))
        ny = torch.where(y > 0.0, -ny, ny)
        n = capped(_gather_rows(scene.con_min, row),
                   _gather_rows(scene.con_max, row), dist,
                   _stack3(x, ny, z))
        local_n = merge(sd.CONE, n)
    if sd.TORUS in present:
        r = _gather_rows(scene.tor_r, row)
        ss = x * x + y * y + z * z
        ps = 1.0 + r * r
        n = _stack3(4.0 * x * (ss - ps), 4.0 * y * (ss - ps),
                    4.0 * z * (ss - ps + 2.0))
        local_n = merge(sd.TORUS, n)

    nmat = scene.prim_nmat[prim]
    world_n = _normalize(nmat[:, :, 0] * local_n[:, None, 0]
                         + nmat[:, :, 1] * local_n[:, None, 1]
                         + nmat[:, :, 2] * local_n[:, None, 2])

    if sd.TRIANGLE in present:
        # One formula for smooth and flat triangles (a flat one stores
        # n1 = n2 = n3, where the interpolation is the identity).
        n1 = _gather_rows(scene.tri_n1, row)
        n2 = _gather_rows(scene.tri_n2, row)
        n3 = _gather_rows(scene.tri_n3, row)
        interp = (n2 * u[:, None] + n3 * v[:, None]
                  + n1 * (1.0 - u - v)[:, None])
        world_n = torch.where((ptype == sd.TRIANGLE)[:, None],
                              _normalize(interp), world_n)
    return world_n


def _present_types(scene: sd.SceneData):
    """The type codes that the scene holds at least one prim of."""
    ns, npl, ncu, ncy, nco, nto, T, _ = scene.counts
    return [code for code, n in ((sd.SPHERE, ns), (sd.PLANE, npl),
                                 (sd.CUBE, ncu), (sd.CYLINDER, ncy),
                                 (sd.CONE, nco), (sd.TORUS, nto),
                                 (sd.TRIANGLE, T)) if n]


def uv_at(scene: sd.SceneData, prim, pts):
    """Each hit prim's uv_mapping at pattern-space points [R, 3] ->
    (u, v), [R] each."""
    prim = prim.long()
    ptype = scene.prim_type[prim]
    row = scene.prim_row[prim]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    pi = math.pi
    present = set(_present_types(scene))
    u = torch.zeros_like(x)
    v = torch.zeros_like(x)

    def merge(code, uu, vv):
        m = ptype == code
        return torch.where(m, uu, u), torch.where(m, vv, v)

    if sd.SPHERE in present:
        theta = torch.atan2(z, x)
        rr = torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        phi = torch.acos(torch.clamp(y / rr, -1.0, 1.0))
        u, v = merge(sd.SPHERE, div(theta + pi, 2.0 * pi),
                     1.0 - div(phi, pi))
    if sd.PLANE in present:
        u, v = merge(sd.PLANE, torch.remainder(x, 1.0),
                     torch.remainder(z, 1.0))
    if sd.CUBE in present:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        # Face selection (cube.rs:132-174).
        fx = (ax >= ay) & (ax >= az)
        fy = ~fx & (ay >= ax) & (ay >= az)
        ur = torch.where(x > 0, (z + 1.0) * 0.5, (1.0 - z) * 0.5)
        vr = (y + 1.0) * 0.5
        uy = (x + 1.0) * 0.5
        vy = torch.where(y > 0, (1.0 - z) * 0.5, (z + 1.0) * 0.5)
        uz = torch.where(z > 0, (x + 1.0) * 0.5, (1.0 - x) * 0.5)
        vz = (y + 1.0) * 0.5
        u, v = merge(sd.CUBE, torch.where(fx, ur, torch.where(fy, uy, uz)),
                     torch.where(fx, vr, torch.where(fy, vy, vz)))
    if sd.CYLINDER in present:
        cmin = _gather_rows(scene.cyl_min, row)
        cmax = _gather_rows(scene.cyl_max, row)
        closed = _gather_rows(scene.cyl_closed, row)
        cap = closed & ((y <= cmin) | (y >= cmax))
        theta = torch.atan2(z, x)
        u, v = merge(sd.CYLINDER,
                     torch.where(cap, (x + 1.0) / 2.0,
                                 div(theta + pi, 2.0 * pi)),
                     torch.where(cap, (z + 1.0) / 2.0, torch.remainder(y, 1.0)))
    if sd.CONE in present:
        cmin = _gather_rows(scene.con_min, row)
        cmax = _gather_rows(scene.con_max, row)
        closed = _gather_rows(scene.con_closed, row)
        cap = closed & ((torch.abs(y - cmin) <= EPSILON)
                        | (torch.abs(y - cmax) <= EPSILON))
        radius = torch.clamp_min(torch.abs(y), 1e-30)
        theta = div(torch.atan2(z, x) + pi, 2.0 * pi)
        height = torch.where(torch.abs(cmax - cmin) < 1e-30,
                             torch.full_like(cmax, 1e-30), cmax - cmin)
        # The reference returns (normalized y, theta) on the side
        # (cone.rs:244-253).
        u, v = merge(sd.CONE,
                     torch.where(cap, (x / radius + 1.0) / 2.0,
                                 (y - cmin) / height),
                     torch.where(cap, (z / radius + 1.0) / 2.0, theta))
    if sd.TORUS in present:
        uu = div(torch.atan2(y, x) + pi, 2.0 * pi)
        dist = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-30)) - 1.0
        vv = div(torch.atan2(z, dist) + pi, 2.0 * pi)
        u, v = merge(sd.TORUS, uu, vv)
    if sd.TRIANGLE in present:
        # Barycentric uv against the world-space triangle tables
        # (triangle.rs:148-170); a textured mesh's pattern-space points
        # are its world points (identity leaf transforms, the OBJ path).
        p1 = _gather_rows(scene.tri_p1, row)
        e1 = _gather_rows(scene.tri_e1, row)
        e2 = _gather_rows(scene.tri_e2, row)
        v2 = pts - p1
        d00 = _dot(e1, e1)
        d01 = _dot(e1, e2)
        d11 = _dot(e2, e2)
        d20 = _dot(v2, e1)
        d21 = _dot(v2, e2)
        denom = d00 * d11 - d01 * d01
        denom = torch.where(torch.abs(denom) < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        u, v = merge(sd.TRIANGLE, (d11 * d20 - d01 * d21) / denom,
                     (d00 * d21 - d01 * d20) / denom)
    return u, v
