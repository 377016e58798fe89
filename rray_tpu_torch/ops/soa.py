"""SoA intersection on rays as V3 component tensors (rray_tpu ops/soa.py):
the analytic hit slots and shadow predicates that the Whitted kernel's
plain version and the torch fast node share, and the fast node's
closest hit and shadow any-hit, whose triangle parts go through the
triangle kernels (kernels/triangles.py, kernels/bvh.py).

Each function takes object-space rays as V3 component tensors and
returns the prim's hit slots as a list of (t, valid) pairs. The formulas
are rray_tpu's, quirks included: the cylinder's negative discriminant
drops its caps too (cylinder.rs:101-102), the cone's linear case returns
early (cone.rs:134-141), and every EPSILON guard sits where the reference
has it (sphere.rs:64-78, plane.rs:51-58, cube.rs:48-77). The torus solves
its quartic (ops/quartic.py) for the rays that enter its padded box. The
CUDA kernel (kernels/csrc/whitted.cu) writes the same expressions in the
same order. `csg_keeps` is the CSG filter over unsorted member slots
that the kernel's plain version and the CUDA kernel share.

Per-prim scalars (ymin, ymax, closed, the torus's minor radius) are
Python numbers or 0-d tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import EPSILON
from ..scene import data as sd
from . import quartic
from .vec import V3, affine_point, affine_vector


@dataclasses.dataclass
class Hit:
    found: Any   # [R] bool
    t: Any       # [R]
    prim: Any    # [R] long
    cls: Any     # [R] long shade-class id
    tri_n: Any = None  # (nx, ny, nz) interpolated triangle normal, or None
    tri: Any = None    # [R] triangle-table row of a triangle winner


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


def torus_box_entry(o: V3, d: V3, minor_r):
    """Does the object-space ray enter the torus's box, padded so the
    slab test is conservative (x, y in [-(1 + r), 1 + r], z in [-r, r])?
    Rays outside it provably miss the torus (rray_tpu soa.py:169-221)."""
    pad = 1e-3
    rx = 1.0 + minor_r + pad
    rz = minor_r + pad

    def inv(c):
        tiny = torch.where(c < 0, torch.full_like(c, -1e-30),
                           torch.full_like(c, 1e-30))
        return 1.0 / torch.where(torch.abs(c) < 1e-30, tiny, c)

    ivx, ivy, ivz = inv(d.x), inv(d.y), inv(d.z)
    tx1 = (-rx - o.x) * ivx
    tx2 = (rx - o.x) * ivx
    ty1 = (-rx - o.y) * ivy
    ty2 = (rx - o.y) * ivy
    tz1 = (-rz - o.z) * ivz
    tz2 = (rz - o.z) * ivz
    tmin = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                       torch.minimum(ty1, ty2)),
                         torch.minimum(tz1, tz2))
    tmax = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                       torch.maximum(ty1, ty2)),
                         torch.maximum(tz1, tz2))
    return (tmin <= tmax) & (tmax >= 0.0)


def _torus_slots(o: V3, d: V3, minor_r):
    """The four quartic roots of the torus in the xy plane's ring
    (torus.rs:47-90) with t > 0, valid only for rays that enter the
    torus's box (`torus_box_entry`: rray_tpu's lax.cond skip becomes
    this mask; the kernel skips the quartic per thread)."""
    enter = torus_box_entry(o, d, minor_r)
    r_sq = minor_r * minor_r
    sum_d_sq = d.dot(d)
    e = o.dot(o) - r_sq + 1.0
    f = o.dot(d)
    a4 = sum_d_sq * sum_d_sq
    a3 = 4.0 * sum_d_sq * f
    a2 = 2.0 * sum_d_sq * e + 4.0 * f * f - 4.0 * (d.x * d.x + d.y * d.y)
    a1 = 4.0 * e * f - 8.0 * (o.x * d.x + o.y * d.y)
    a0 = e * e - 4.0 * (o.x * o.x + o.y * o.y)
    roots, valids = quartic.solve_quartic_parts(a4, a3, a2, a1, a0)
    return [(r, ok & (r > 0.0) & enter) for r, ok in zip(roots, valids)]


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


def _leaf_slots(scene, kind: int, row: int, ro: V3, rd: V3):
    """Hit slots of one analytic leaf (local-space closed forms)."""
    if kind == sd.SPHERE:
        inv = scene.sph_inv[row]
        return _sphere_slots(affine_point(inv, ro), affine_vector(inv, rd))
    if kind == sd.PLANE:
        inv = scene.pla_inv[row]
        return _plane_slots(affine_point(inv, ro), affine_vector(inv, rd))
    if kind == sd.CUBE:
        inv = scene.cub_inv[row]
        return _cube_slots(affine_point(inv, ro), affine_vector(inv, rd))
    if kind == sd.CYLINDER:
        inv = scene.cyl_inv[row]
        return _cylinder_slots(affine_point(inv, ro), affine_vector(inv, rd),
                               scene.cyl_min[row], scene.cyl_max[row],
                               scene.cyl_closed[row])
    if kind == sd.CONE:
        inv = scene.con_inv[row]
        return _cone_slots(affine_point(inv, ro), affine_vector(inv, rd),
                           scene.con_min[row], scene.con_max[row],
                           scene.con_closed[row])
    if kind == sd.TORUS:
        inv = scene.tor_inv[row]
        return _torus_slots(affine_point(inv, ro), affine_vector(inv, rd),
                            scene.tor_r[row])
    raise ValueError(f"no slot form for prim kind {kind}")


def _leaf_occludes(scene, kind: int, row: int, ro: V3, rd: V3, dist):
    """Does this leaf have a hit with 0 <= t < dist? Spheres and planes
    use their sqrt- and divide-free interval forms."""
    if kind == sd.SPHERE:
        inv = scene.sph_inv[row]
        return _sphere_occludes_local(affine_point(inv, ro),
                                      affine_vector(inv, rd), dist)
    if kind == sd.PLANE:
        inv = scene.pla_inv[row]
        return _plane_occludes_local(affine_point(inv, ro),
                                     affine_vector(inv, rd), dist)
    hit = torch.zeros_like(ro.x, dtype=torch.bool)
    for t, valid in _leaf_slots(scene, kind, row, ro, rd):
        hit = hit | (valid & (t >= 0.0) & (t < dist))
    return hit


def member_pids(scene):
    """Prim ids that are operands of some CSG node (static)."""
    return tuple(p for p, m in enumerate(scene.csg_member_static) if m)


def csg_members_analytic(scene) -> bool:
    """True when every CSG operand is an analytic leaf (no mesh inside a
    CSG): the scenes whose CSG the whitted kernel filters."""
    return all(scene.prim_kinds[p] != sd.TRIANGLE for p in member_pids(scene))


def csg_keeps(ts, valids, ops_and_sides):
    """The static pairwise-parity CSG filter over UNSORTED slot lists
    (rray_tpu soa.py:814-857; csg.rs:163-195).

    `ts`/`valids`: per-slot [R] tensors in static (prim, slot) order;
    `ops_and_sides`: innermost-first (op, per-slot side tuple) with side
    0 (not under this CSG), 1 (left) or 2 (right). Slot j precedes slot
    i in the stable sorted order iff t_j < t_i, or t_j == t_i and j < i.
    A slot's in-left / in-right state is the parity of the valid slots of
    each side that precede it. Returns the surviving valid masks."""
    K = len(ts)
    before = [[None] * K for _ in range(K)]
    for j in range(K):
        for i in range(K):
            if i != j:
                before[j][i] = (ts[j] <= ts[i]) if j < i else (ts[j] < ts[i])
    for op, side in ops_and_sides:
        keeps = []
        for i in range(K):
            if side[i] == 0:
                keeps.append(valids[i])
                continue
            parity = {1: torch.zeros_like(valids[i]),
                      2: torch.zeros_like(valids[i])}
            for j in range(K):
                if j != i and side[j] != 0:
                    parity[side[j]] = parity[side[j]] ^ (valids[j]
                                                         & before[j][i])
            inl, inr = parity[1], parity[2]
            if op == sd.CSG_UNION:
                allowed = ~inr if side[i] == 1 else ~inl
            elif op == sd.CSG_INTERSECTION:
                allowed = inr if side[i] == 1 else inl
            else:  # difference
                allowed = ~inr if side[i] == 1 else inl
            keeps.append(valids[i] & allowed)
        valids = keeps
    return valids


def _tri_comps(scene, normals: bool):
    """The triangle table's [T] columns p1 e1 e2 (and n1 n2 n3), once per
    scene."""
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    if normals:
        tabs += (scene.tri_n1, scene.tri_n2, scene.tri_n3)
    return scene.cached(("tri_comps", normals), lambda: tuple(
        tbl[:, j].contiguous() for tbl in tabs for j in range(3)))


def _tri_aux(scene):
    """The kernels' payload columns, prim id and shade class as floats
    (exact below 2^24), once per scene."""
    return scene.cached("tri_aux", lambda: (
        scene.tri_prim.to(scene.dtype), scene.tri_class.to(scene.dtype)))


def _bvh_tables(scene):
    """The BVH kernel's tree and tables for the scene's mesh
    (kernels/bvh.py card_tables, with normals and payload), built once
    per scene; its closest and any-hit calls share them."""
    from ..kernels import bvh

    return scene.cached("bvh", lambda: bvh.card_tables(
        _tri_comps(scene, normals=True), _tri_aux(scene)))


def _tri_tables(scene):
    """The triangle kernels' tables for the scene's mesh
    (kernels/triangles.py chunk_tables, with normals and payload), built
    once per scene; its closest and any-hit calls share them."""
    from ..kernels import triangles

    return scene.cached("tri", lambda: triangles.chunk_tables(
        _tri_comps(scene, normals=True), _tri_aux(scene)))


def _triangle_best(scene, ro: V3, rd: V3, settings, t_init):
    """Closest triangle hit with t < t_init (rray_tpu soa.py
    _pallas_triangle_best): the BVH kernel for meshes of at least
    settings.bvh_min_tris triangles, the linear chunk kernel below that.
    Returns (t, prim, cls, (nx, ny, nz), row); the kernels select the
    winner's prim id and shade class as float payload columns; row is
    its triangle-table row."""
    from ..kernels import bvh, triangles

    rays = (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z)
    aux = _tri_aux(scene)
    tri = _tri_comps(scene, normals=True)
    if scene.counts[6] >= settings.bvh_min_tris:
        outs = bvh.bvh_closest_triangle(*rays, tri, dist=t_init, aux=aux,
                                        tables=_bvh_tables(scene))
    else:
        outs = triangles.closest_triangle(*rays, tri, t_init=t_init, aux=aux,
                                          tables=_tri_tables(scene))
    t, _, _, row, nx, ny, nz, prim, cls = outs
    return t, prim.long(), cls.long(), (nx, ny, nz), row


def _triangle_any(scene, ro: V3, rd: V3, settings, distance):
    """Bounded triangle any-hit (rray_tpu soa.py _pallas_triangle_any)
    -> bool [R]."""
    from ..kernels import bvh, triangles

    rays = (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z)
    tri = _tri_comps(scene, normals=False)
    if scene.counts[6] >= settings.bvh_min_tris:
        t = bvh.bvh_closest_triangle(*rays, tri, dist=distance, any_hit=True,
                                     tables=_bvh_tables(scene))[0]
        return t < distance
    return triangles.any_triangle(*rays, tri, distance,
                                  tables=_tri_tables(scene)) != 0


def analytic_closest(scene, ro: V3, rd: V3):
    """Closest analytic hit -> (t, prim, cls) [R]: every slot merged by a
    running strict `<`, so the lowest prim wins ties; t = +inf on a
    miss."""
    inf = torch.full_like(ro.x, float("inf"))
    best_t = inf
    best_prim = torch.zeros_like(ro.x, dtype=torch.long)
    best_cls = torch.zeros_like(ro.x, dtype=torch.long)
    for pid, (kind, row) in enumerate(zip(scene.prim_kinds,
                                          scene.prim_rows_static)):
        if kind == sd.TRIANGLE:
            continue
        for t, valid in _leaf_slots(scene, kind, row, ro, rd):
            t = torch.where(valid & (t >= 0.0), t, inf)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_prim = torch.where(better, pid, best_prim)
            best_cls = torch.where(better, scene.prim_class_static[pid],
                                   best_cls)
    return best_t, best_prim, best_cls


def closest_hit_soa(scene, ro: V3, rd: V3, settings) -> Hit:
    """First t >= 0 hit across all primitives: the analytic closest hit,
    then the triangle kernel seeded with its t, merged by `ct < best_t`
    (analytic prims win ties against triangles)."""
    best_t, best_prim, best_cls = analytic_closest(scene, ro, rd)
    tri_n = tri = None
    if scene.counts[6]:
        ct, cp, ccls, cn, row = _triangle_best(scene, ro, rd, settings,
                                               best_t)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_prim = torch.where(better, cp, best_prim)
        best_cls = torch.where(better, ccls, best_cls)
        tri_n = tuple(torch.where(better, c, 0.0) for c in cn)
        tri = torch.where(better, row.long().clamp_min(0), 0)
    return Hit(found=torch.isfinite(best_t), t=best_t, prim=best_prim,
               cls=best_cls, tri_n=tri_n, tri=tri)


def any_hit_soa(scene, ro: V3, rd: V3, distance, settings):
    """Shadow test: any hit with 0 <= t < distance (scene.rs:234-245)."""
    hit = torch.zeros_like(ro.x, dtype=torch.bool)
    for kind, row in zip(scene.prim_kinds, scene.prim_rows_static):
        if kind != sd.TRIANGLE:
            hit = hit | _leaf_occludes(scene, kind, row, ro, rd, distance)
    if scene.counts[6]:
        hit = hit | _triangle_any(scene, ro, rd, settings, distance)
    return hit
