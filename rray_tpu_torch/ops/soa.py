"""SoA intersection on rays as V3 component tensors (rray_tpu ops/soa.py):
the analytic hit slots and shadow predicates that the Whitted kernel's
plain version and the torch nodes share, the closest hit and shadow
any-hit, whose triangle parts go through the triangle kernels
(kernels/triangles.py, kernels/bvh.py), and the sorted node's slot
lists: sorted [K, R] slots with the CSG filter replayed over them, the
hybrid CSG path that filters only the CSG operands' slots, and the
n1/n2 containers walk, with its torch folds over a mesh in chunks of
settings.tri_chunk triangles.

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

from ..config import EPSILON, hit_match_tol
from ..scene import data as sd
from . import quartic
from .vec import V3, affine_point, affine_vector


INF = float("inf")


@dataclasses.dataclass
class Hit:
    found: Any   # [R] bool
    t: Any       # [R]
    prim: Any    # [R] long
    cls: Any     # [R] long shade-class id
    tri_n: Any = None  # (nx, ny, nz) interpolated triangle normal, or None
    tri: Any = None    # [R] triangle-table row of a triangle winner
    u: Any = None      # [R] barycentric u, v of a triangle winner: the
    v: Any = None      # sorted slots carry these instead of tri_n


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


def _is_member(scene, pid: int) -> bool:
    ms = scene.csg_member_static
    return bool(ms[pid]) if pid < len(ms) else False


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
    """The triangle table's [T] columns p1 e1 e2 (and n1 n2 n3), detached,
    once per scene: what the kernels read."""
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    if normals:
        tabs += (scene.tri_n1, scene.tri_n2, scene.tri_n3)
    return scene.cached(("tri_comps", normals), lambda: tuple(
        tbl.detach()[:, j].contiguous() for tbl in tabs for j in range(3)))


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


def _mt_winner(live, ro_comps, rd_comps, rows):
    """The winning triangle's Moller-Trumbore t, u, v and interpolated
    normal (triangle.rs:72-94, smooth_triangle.rs:99-101) recomputed from
    its gathered [R, 18] table row (rray_tpu soa.py _mt_winner_xla), as
    a plain chain that autograd differentiates. `live` masks the
    division where nothing was hit (those rays gather row 0)."""
    g = rows.unbind(1)
    ox, oy, oz = ro_comps
    dx, dy, dz = rd_comps
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z = g[:9]
    cx = dy * e2z - dz * e2y
    cy = dz * e2x - dx * e2z
    cz = dx * e2y - dy * e2x
    det = e1x * cx + e1y * cy + e1z * cz
    f = 1.0 / torch.where(live & (torch.abs(det) >= EPSILON), det, 1.0)
    sx, sy, sz = ox - p1x, oy - p1y, oz - p1z
    u = f * (sx * cx + sy * cy + sz * cz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    w1 = 1.0 - u - v
    return (t, u, v) + tuple(w1 * g[9 + k] + u * g[12 + k] + v * g[15 + k]
                             for k in range(3))


class ClosestTriangle(torch.autograd.Function):
    """The closest-triangle kernels under autograd (rray_tpu soa.py
    _kernel_closest). Forward: `launch(ro_comps, rd_comps, t_init)`, the
    BVH or chunk kernel on CUDA tensors and its plain version on CPU
    tensors, -> (t, u, v, nx, ny, nz, idx, prim, cls). Backward: the
    winner held fixed (exact almost everywhere, as an argmin), its t, u,
    v and normal recomputed by `_mt_winner` from one row gather of the
    stacked [T, 18] table, and the rows' cotangents summed into the six
    [T, 3] tables with index_add_ (rray_tpu's _winner_segment_sum).
    t_init, which only bounds the search, and the payloads get no
    gradient."""

    @staticmethod
    def forward(ctx, launch, ox, oy, oz, dx, dy, dz, t_init, *tables):
        t, u, v, idx, nx, ny, nz, prim, cls = launch(
            (ox, oy, oz), (dx, dy, dz), t_init)
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, t, idx, *tables)
        ctx.mark_non_differentiable(idx, prim, cls)
        return t, u, v, nx, ny, nz, idx, prim, cls

    @staticmethod
    def backward(ctx, *cts):
        ox, oy, oz, dx, dy, dz, t, idx, *tables = ctx.saved_tensors
        live = torch.isfinite(t)
        cts = [torch.where(live, c, 0.0) if c is not None
               else torch.zeros_like(t) for c in cts[:6]]
        stacked = torch.cat(tables, dim=1)
        T = stacked.shape[0]
        idxc = idx.long().clamp(0, T - 1)
        with torch.enable_grad():
            rays = [c.detach().requires_grad_() for c in
                    (ox, oy, oz, dx, dy, dz)]
            rows = stacked.detach()[idxc].requires_grad_()
            outs = _mt_winner(live, rays[:3], rays[3:], rows)
            grads = torch.autograd.grad(outs, rays + [rows], cts)
        d_tbl = torch.zeros_like(stacked).index_add_(0, idxc, grads[6])
        return (None, *grads[:6], None) + tuple(d_tbl.split(3, dim=1))


def _triangle_best(scene, ro: V3, rd: V3, settings, t_init):
    """Closest triangle hit with t < t_init (rray_tpu soa.py
    _pallas_triangle_best): the BVH kernel for meshes of at least
    settings.bvh_min_tris triangles, the linear chunk kernel below that,
    through ClosestTriangle. Returns (t, prim,
    cls, (nx, ny, nz), row); the kernels select the winner's prim id and
    shade class as float payload columns; row is its triangle-table
    row."""
    from ..kernels import bvh, triangles

    aux = _tri_aux(scene)
    tri = _tri_comps(scene, normals=True)
    if scene.counts[6] >= settings.bvh_min_tris:
        tables = _bvh_tables(scene)
        launch = lambda o, d, t0: bvh.bvh_closest_triangle(
            o, d, tri, dist=t0, aux=aux, tables=tables)
    else:
        tables = _tri_tables(scene)
        launch = lambda o, d, t0: triangles.closest_triangle(
            o, d, tri, t_init=t0, aux=aux, tables=tables)
    t, _, _, nx, ny, nz, row, prim, cls = ClosestTriangle.apply(
        launch, ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, t_init, scene.tri_p1,
        scene.tri_e1, scene.tri_e2, scene.tri_n1, scene.tri_n2, scene.tri_n3)
    return t, prim.long(), cls.long(), (nx, ny, nz), row


def _triangle_any(scene, ro: V3, rd: V3, settings, distance):
    """Bounded triangle any-hit (rray_tpu soa.py _pallas_triangle_any)
    -> bool [R]. A 0/1 outcome: its inputs are taken detached, as
    rray_tpu stops their gradient."""
    from ..kernels import bvh, triangles

    rays = ((ro.x.detach(), ro.y.detach(), ro.z.detach()),
            (rd.x.detach(), rd.y.detach(), rd.z.detach()))
    distance = distance.detach()
    tri = _tri_comps(scene, normals=False)
    if scene.counts[6] >= settings.bvh_min_tris:
        t = bvh.bvh_closest_triangle(*rays, tri, dist=distance, any_hit=True,
                                     tables=_bvh_tables(scene))[0]
        return t < distance
    return triangles.any_triangle(*rays, tri, distance,
                                  tables=_tri_tables(scene)) != 0


def analytic_closest(scene, ro: V3, rd: V3, skip_members: bool = False):
    """Closest analytic hit -> (t, prim, cls) [R]: every slot merged by a
    running strict `<`, so the lowest prim wins ties; t = +inf on a
    miss. skip_members leaves out the CSG operands."""
    inf = torch.full_like(ro.x, INF)
    best_t = inf
    best_prim = torch.zeros_like(ro.x, dtype=torch.long)
    best_cls = torch.zeros_like(ro.x, dtype=torch.long)
    for pid, (kind, row) in enumerate(zip(scene.prim_kinds,
                                          scene.prim_rows_static)):
        if kind == sd.TRIANGLE or (skip_members and _is_member(scene, pid)):
            continue
        for t, valid in _leaf_slots(scene, kind, row, ro, rd):
            t = torch.where(valid & (t >= 0.0), t, inf)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_prim = torch.where(better, pid, best_prim)
            best_cls = torch.where(better, scene.prim_class_static[pid],
                                   best_cls)
    return best_t, best_prim, best_cls


def closest_hit_soa(scene, ro: V3, rd: V3, settings,
                    skip_members: bool = False) -> Hit:
    """First t >= 0 hit across all primitives: the analytic closest hit,
    then the triangle kernel seeded with its t, merged by `ct < best_t`
    (analytic prims win ties against triangles). skip_members leaves
    out the CSG operands (the hybrid CSG path merges their filtered hit
    in separately)."""
    best_t, best_prim, best_cls = analytic_closest(scene, ro, rd,
                                                   skip_members)
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


def any_hit_soa(scene, ro: V3, rd: V3, distance, settings,
                skip_members: bool = False):
    """Shadow test: any hit with 0 <= t < distance (scene.rs:234-245);
    skip_members leaves out the CSG operands."""
    hit = torch.zeros_like(ro.x, dtype=torch.bool)
    for pid, (kind, row) in enumerate(zip(scene.prim_kinds,
                                          scene.prim_rows_static)):
        if kind == sd.TRIANGLE or (skip_members and _is_member(scene, pid)):
            continue
        hit = hit | _leaf_occludes(scene, kind, row, ro, rd, distance)
    if scene.counts[6]:
        hit = hit | _triangle_any(scene, ro, rd, settings, distance)
    return hit


# ---------------------------------------------------------------------------
# The sorted node's slot lists (rray_tpu ops/soa.py:295, 715-1311).
# ---------------------------------------------------------------------------

def _tri_chunks(scene, chunk: int):
    """The triangle table as [n_chunks, chunk] columns, zero-padded ->
    (n_chunks, chunk, p1, e1, e2, prim ids, live mask), once per scene
    and chunk size (the torch folds differentiate through them)."""
    def make():
        T = scene.counts[6]
        pad = (-T) % chunk
        n_chunks = (T + pad) // chunk

        def comp(col):
            col = torch.cat([col, col.new_zeros(pad)])
            return col.reshape(n_chunks, chunk)

        p1, e1, e2 = (tuple(comp(tbl[:, j]) for j in range(3))
                      for tbl in (scene.tri_p1, scene.tri_e1, scene.tri_e2))
        pid = comp(scene.tri_prim.long())
        live = (torch.arange(n_chunks * chunk, device=scene.device)
                < T).reshape(n_chunks, chunk)
        return n_chunks, chunk, p1, e1, e2, pid, live

    return scene.cached(("tri_chunks", chunk), make, grad=True)


def _mesh_chunks(scene, settings):
    T = scene.counts[6]
    return _tri_chunks(scene, min(settings.tri_chunk, max(T, 1)))


def _tri_chunk_eval(ro: V3, rd: V3, p1, e1, e2):
    """Raw [R, C] Moller-Trumbore values (t, u, v, ok) of every ray
    against one chunk's [C] triangle columns (triangle.rs:72-94)."""
    dx, dy, dz = rd.x[:, None], rd.y[:, None], rd.z[:, None]
    ox, oy, oz = ro.x[:, None], ro.y[:, None], ro.z[:, None]
    e1x, e1y, e1z = e1[0][None, :], e1[1][None, :], e1[2][None, :]
    e2x, e2y, e2z = e2[0][None, :], e2[1][None, :], e2[2][None, :]
    p1x, p1y, p1z = p1[0][None, :], p1[1][None, :], p1[2][None, :]
    cx = dy * e2z - dz * e2y
    cy = dz * e2x - dx * e2z
    cz = dx * e2y - dy * e2x
    det = e1x * cx + e1y * cy + e1z * cz
    ok = torch.abs(det) >= EPSILON
    f = 1.0 / torch.where(ok, det, 1.0)
    sx = ox - p1x
    sy = oy - p1y
    sz = oz - p1z
    u = f * (sx * cx + sy * cy + sz * cz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return t, u, v, ok


def _sort_network(ts, prims):
    """Odd-even transposition network over K slot lists, a strict `>`
    per compare-swap, so ties keep insertion order (the reference's
    stable Vec sort) -> [K, R] (t, prim, valid)."""
    ts, prims = list(ts), list(prims)
    K = len(ts)
    for rnd in range(K):
        for i in range(rnd % 2, K - 1, 2):
            swap = ts[i] > ts[i + 1]
            ts[i], ts[i + 1] = (torch.where(swap, ts[i + 1], ts[i]),
                                torch.where(swap, ts[i], ts[i + 1]))
            prims[i], prims[i + 1] = (torch.where(swap, prims[i + 1],
                                                  prims[i]),
                                      torch.where(swap, prims[i],
                                                  prims[i + 1]))
    t = torch.stack(ts)
    return t, torch.stack(prims), torch.isfinite(t)


def _leaf_slot_lists(scene, pids, ro: V3, rd: V3):
    """Every slot of the analytic prims `pids`, invalid ones at +inf ->
    (t list, prim list) in static (prim, slot) order."""
    ts, prims = [], []
    for pid in pids:
        kind = scene.prim_kinds[pid]
        if kind == sd.TRIANGLE:
            raise ValueError(f"prim {pid} is a triangle: it has no "
                             "closed-form slots")
        for t, valid in _leaf_slots(scene, kind,
                                    scene.prim_rows_static[pid], ro, rd):
            ts.append(torch.where(valid, t, INF))
            prims.append(torch.full_like(ro.x, pid, dtype=torch.long))
    return ts, prims


def sorted_slots_soa(scene, ro: V3, rd: V3):
    """Every analytic hit slot sorted ascending by t -> [K, R] (t, prim,
    valid) (scene.rs:97-106). Analytic scenes only."""
    return _sort_network(*_leaf_slot_lists(
        scene, range(len(scene.prim_kinds)), ro, rd))


def sorted_member_slots(scene, ro: V3, rd: V3):
    """Sorted [K, R] (t, prim, valid) over the CSG operands alone
    (analytic): the only slots the CSG filter reads or drops."""
    return _sort_network(*_leaf_slot_lists(scene, member_pids(scene), ro,
                                           rd))


def _member_slots_filtered_nosort(scene, ro: V3, rd: V3):
    """The CSG operands' slots, UNSORTED, with the CSG filter
    (csg.rs:177-195) applied by pairwise parities (`csg_keeps`) ->
    (t list, static prim ids, keep list)."""
    ts, pids, valids = [], [], []
    for pid in member_pids(scene):
        kind = scene.prim_kinds[pid]
        if kind == sd.TRIANGLE:
            raise ValueError("the hybrid CSG path takes analytic operands "
                             "only")
        for t, valid in _leaf_slots(scene, kind,
                                    scene.prim_rows_static[pid], ro, rd):
            ts.append(t)
            pids.append(pid)
            valids.append(valid)
    ops_and_sides = tuple(
        (op, tuple(scene.csg_side_static[ci][pid] for pid in pids))
        for ci, op in enumerate(scene.csg_ops))
    return ts, pids, csg_keeps(ts, valids, ops_and_sides)


def csg_filtered_member_hit(scene, ro: V3, rd: V3):
    """The first surviving operand slot with t >= 0 (a strict `<` keeps
    the earlier slot on ties, as the stable sort does) -> (found, t,
    prim, the filtered slots as [K, R] stacks (t, prim, keep))."""
    ts, pids, keeps = _member_slots_filtered_nosort(scene, ro, rd)
    found = torch.zeros_like(ro.x, dtype=torch.bool)
    t_out = torch.full_like(ro.x, INF)
    prim_out = torch.zeros_like(ro.x, dtype=torch.long)
    for t, pid, keep in zip(ts, pids, keeps):
        take = keep & (t >= 0.0) & (t < t_out)
        t_out = torch.where(take, t, t_out)
        prim_out = torch.where(take, pid, prim_out)
        found = found | take
    t_out = torch.where(found, t_out, 0.0)
    mslots = (torch.stack(ts),
              torch.stack([torch.full_like(prim_out, p) for p in pids]),
              torch.stack(keeps))
    return found, t_out, prim_out, mslots


def _where_opt(mask, a, b):
    return None if b is None else torch.where(mask, a, b)


def closest_hit_hybrid(scene, ro: V3, rd: V3, settings):
    """Closest hit of a CSG scene whose operands are all analytic: the
    closest hit over everything else (meshes through the kernels),
    merged with the CSG-filtered operand hit -> (Hit, filtered operand
    slots)."""
    hit = closest_hit_soa(scene, ro, rd, settings, skip_members=True)
    mfound, mt, mprim, mslots = csg_filtered_member_hit(scene, ro, rd)
    better = mfound & (mt < hit.t)
    mcls = torch.zeros_like(hit.cls)
    for pid in member_pids(scene):
        mcls = torch.where(mprim == pid, scene.prim_class_static[pid], mcls)
    # tri_n passes through: a ray where an (analytic) operand won never
    # reads the triangle lanes.
    merged = Hit(found=hit.found | mfound,
                 t=torch.where(better, mt, hit.t),
                 prim=torch.where(better, mprim, hit.prim),
                 cls=torch.where(better, mcls, hit.cls),
                 tri_n=hit.tri_n, tri=_where_opt(better, 0, hit.tri),
                 u=_where_opt(better, 0.0, hit.u),
                 v=_where_opt(better, 0.0, hit.v))
    return merged, mslots


def _sort_rows(keys, *ops):
    """A stable sort of [K, R] `keys` along K, `ops` permuted alike."""
    keys, order = torch.sort(keys, dim=0, stable=True)
    return (keys,) + tuple(torch.gather(a, 0, order) for a in ops)


def sorted_slots_full_soa(scene, ro: V3, rd: V3, settings):
    """Sorted slots with triangle meshes -> [K, R] (t, prim, valid, u, v,
    tri): the analytic slots, and per ray the K_tri = min(max_hits, T)
    smallest-t triangle crossings, taken chunk by chunk (K_tri masked
    argmin extractions per chunk, merged into the running prefix by a
    stable sort)."""
    pids = [p for p, k in enumerate(scene.prim_kinds) if k != sd.TRIANGLE]
    ts, prims = _leaf_slot_lists(scene, pids, ro, rd)
    R = ro.x.shape[0]
    if ts:
        t, prim = torch.stack(ts), torch.stack(prims)
    else:
        t = ro.x.new_zeros((0, R))
        prim = torch.zeros((0, R), dtype=torch.long, device=ro.x.device)
    u = v = torch.zeros_like(t)
    tri = torch.zeros_like(prim)

    T = scene.counts[6]
    if T:
        K_tri = min(settings.max_hits, T)
        n_chunks, chunk, p1, e1, e2, pid_tbl, live = _mesh_chunks(scene,
                                                                  settings)
        cols = torch.arange(chunk, device=ro.x.device)[None, :]

        def chunk_topk(ci):
            tt, uu, vv, ok = _tri_chunk_eval(
                ro, rd, tuple(c[ci] for c in p1), tuple(c[ci] for c in e1),
                tuple(c[ci] for c in e2))
            tt = torch.where(ok & live[ci][None, :], tt, INF)
            outs = []
            for _ in range(K_tri):
                idx = torch.argmin(tt, dim=1)
                take = lambda a: torch.gather(a, 1, idx[:, None])[:, 0]
                outs.append((take(tt), take(uu), take(vv), pid_tbl[ci][idx],
                             ci * chunk + idx))
                tt = torch.where(cols == idx[:, None], INF, tt)
            return tuple(torch.stack([o[i] for o in outs]) for i in range(5))

        if n_chunks == 1:
            best = chunk_topk(0)
        else:
            # The running prefix starts empty (+inf), as rray_tpu's scan
            # carry does: its rows sort first among the +inf ties.
            zf = ro.x.new_zeros((K_tri, R))
            zi = torch.zeros_like(zf, dtype=torch.long)
            best = (zf + INF, zf, zf, zi, zi)
        for ci in range(1 if n_chunks == 1 else 0, n_chunks):
            merged = [torch.cat([a, b]) for a, b in zip(best,
                                                        chunk_topk(ci))]
            bt, bu, bv, bp, bi = _sort_rows(*merged)
            best = (bt[:K_tri], bu[:K_tri], bv[:K_tri], bp[:K_tri],
                    bi[:K_tri])
        t = torch.cat([t, best[0]])
        u = torch.cat([u, best[1]])
        v = torch.cat([v, best[2]])
        prim = torch.cat([prim, best[3]])
        tri = torch.cat([tri, best[4]])

    t, prim, u, v, tri = _sort_rows(t, prim, u, v, tri)
    return t, prim, torch.isfinite(t), u, v, tri


def apply_csg_soa(scene, slots):
    """Replay filter_intersections (csg.rs:177-195) per CSG node over the
    sorted [K, R] slots, innermost first, carrying the in-left/in-right
    parities along K. Dropped slots keep their t but lose validity."""
    t, prim, valid = slots[:3]
    for ci, op in enumerate(scene.csg_ops):
        side_table = scene.csg_side[ci].long()
        inl = inr = torch.zeros_like(valid[0])
        keeps = []
        for k in range(t.shape[0]):
            s = torch.where(valid[k], side_table[prim[k]], 0)
            lhit = s == 1
            if op == sd.CSG_UNION:
                allowed = (lhit & ~inr) | (~lhit & ~inl)
            elif op == sd.CSG_INTERSECTION:
                allowed = (lhit & inr) | (~lhit & inl)
            else:  # difference
                allowed = (lhit & ~inr) | (~lhit & inl)
            keeps.append(valid[k] & ((s == 0) | allowed))
            inl, inr = inl ^ lhit, inr ^ (s == 2)
        valid = torch.stack(keeps)
    return (t, prim, valid) + tuple(slots[3:])


def select_hit_slots(slots):
    """First valid slot with t >= 0 (scene.rs:128-136) -> (found, t,
    prim, slot index) [R], plus (u, v, tri) when the slots carry them."""
    t, prim, valid = slots[:3]
    found = torch.zeros_like(valid[0])
    t_out = torch.zeros_like(t[0])
    prim_out = torch.zeros_like(prim[0])
    idx_out = torch.zeros_like(prim[0])
    extras = [torch.zeros_like(a[0]) for a in slots[3:6]]
    for k in range(t.shape[0]):
        take = ~found & valid[k] & (t[k] >= 0.0)
        t_out = torch.where(take, t[k], t_out)
        prim_out = torch.where(take, prim[k], prim_out)
        idx_out = torch.where(take, k, idx_out)
        extras = [torch.where(take, a[k], e)
                  for a, e in zip(slots[3:6], extras)]
        found = found | take
    return (found, t_out, prim_out, idx_out) + tuple(extras)


def refractive_indices_soa(scene, slots, hit_idx, depth=8):
    """n1/n2 by the containers walk over sorted slots
    (intersection.rs:61-92): a [D, R] stack of prims, with append on
    enter, remove-by-value on exit, and the top read just before and
    just after the hit's own slot. D is floored at the prim count (the
    list holds each prim at most once, so it cannot overflow) and capped
    at 64."""
    t, prim, valid = slots[:3]
    D = max(int(depth) if depth else 8, 1)
    D = min(max(D, int(scene.counts[7])), 64)
    zero = torch.zeros_like(prim[0])

    def top_ior(stack, size):
        top = zero
        for d in range(D):
            top = torch.where(size == d + 1, stack[d], top)
        return torch.where(size > 0, scene.mat_ior[top], 1.0)

    stack, size = [zero] * D, zero
    n1 = n2 = torch.ones_like(t[0])
    for k in range(t.shape[0]):
        prim_k, valid_k, hit_k = prim[k], valid[k], hit_idx == k
        n1 = torch.where(hit_k, top_ior(stack, size), n1)
        match = [(stack[d] == prim_k) & (size > d) for d in range(D)]
        found = torch.zeros_like(valid_k)
        for m in match:
            found = found | m
        shift = torch.zeros_like(valid_k)
        new_rows = []
        for d in range(D):
            shift = shift | match[d]
            above = stack[d + 1] if d + 1 < D else zero
            removed = torch.where(shift, above, stack[d])
            pushed = torch.where(size == d, prim_k, stack[d])
            new_rows.append(torch.where(
                valid_k, torch.where(found, removed, pushed), stack[d]))
        stack = new_rows
        size = torch.where(valid_k, torch.where(
            found, size - 1, torch.clamp_max(size + 1, D)), size)
        n2 = torch.where(hit_k, top_ior(stack, size), n2)
    return n1, n2


def refractive_indices_direct(scene, ro: V3, rd: V3, t_hit, hit_prim,
                              settings, member_slots=None):
    """n1/n2 without a sorted slot list: a prim contains the hit iff it
    has an odd number of crossings before t_hit, and the innermost
    container is the one whose latest crossing is largest in t. n1
    counts the crossings strictly before the hit, n2 the hit's own
    crossing too, matched by prim and hit_match_tol (the crossing is
    re-derived, so its t need not equal the closest hit's bit for bit).
    With `member_slots` (the hybrid CSG path) the CSG operands count
    only their surviving slots. A mesh folds chunk by chunk."""
    neg = -INF
    tol = hit_match_tol(ro.x.dtype) * torch.clamp_min(torch.abs(t_hit), 1.0)
    zero_i = torch.zeros_like(hit_prim)

    def fold(best_t, best_prim, cand_t, cand_ok, pid):
        better = cand_ok & (cand_t > best_t)
        return (torch.where(better, cand_t, best_t),
                torch.where(better, pid, best_prim))

    best = [torch.full_like(ro.x, neg), zero_i,
            torch.full_like(ro.x, neg), zero_i]

    def accumulate(pid, slot_list):
        cnt_s = cnt_l = zero_i
        last_s = last_l = torch.full_like(ro.x, neg)
        for t, valid in slot_list:
            is_hit = (hit_prim == pid) & (torch.abs(t - t_hit) <= tol)
            before = valid & (t < t_hit)
            in_s = before & ~is_hit
            in_l = before | (valid & is_hit)
            cnt_s = cnt_s + in_s.long()
            last_s = torch.maximum(last_s, torch.where(in_s, t, neg))
            cnt_l = cnt_l + in_l.long()
            last_l = torch.maximum(last_l, torch.where(in_l, t, neg))
        best[0], best[1] = fold(best[0], best[1], last_s, cnt_s % 2 == 1,
                                pid)
        best[2], best[3] = fold(best[2], best[3], last_l, cnt_l % 2 == 1,
                                pid)

    for pid, (kind, row) in enumerate(zip(scene.prim_kinds,
                                          scene.prim_rows_static)):
        if kind == sd.TRIANGLE:
            continue
        if member_slots is not None and _is_member(scene, pid):
            continue  # counted below from the CSG-filtered slots
        accumulate(pid, _leaf_slots(scene, kind, row, ro, rd))

    if member_slots is not None:
        # The operands toggle containers only through the slots that
        # survive the CSG filter (the reference's xs holds its output).
        mt, mprim, mvalid = member_slots[:3]
        for pid in member_pids(scene):
            accumulate(pid, [(mt[k], mvalid[k] & (mprim[k] == pid))
                             for k in range(mt.shape[0])])

    if scene.counts[6]:
        n_chunks, chunk, p1, e1, e2, pid_tbl, live = _mesh_chunks(scene,
                                                                  settings)
        for ci in range(n_chunks):
            tt, _, _, ok = _tri_chunk_eval(
                ro, rd, tuple(c[ci] for c in p1), tuple(c[ci] for c in e1),
                tuple(c[ci] for c in e2))
            cpid = torch.where(live[ci], pid_tbl[ci], -1)
            is_hit = ((cpid[None, :] == hit_prim[:, None])
                      & (torch.abs(tt - t_hit[:, None]) <= tol[:, None]))
            before = ok & (tt < t_hit[:, None])
            for j, okp in ((0, before & ~is_hit), (2, before | (ok & is_hit))):
                ttm = torch.where(okp, tt, neg)
                idx = torch.argmax(ttm, dim=1)  # the first max, as jnp's
                ct = torch.gather(ttm, 1, idx[:, None])[:, 0]
                best[j], best[j + 1] = fold(best[j], best[j + 1], ct,
                                            torch.isfinite(ct), cpid[idx])

    def to_ior(best_t, best_prim):
        ior = scene.mat_ior[torch.clamp_min(best_prim, 0)]
        return torch.where(torch.isfinite(best_t), ior, 1.0)

    return to_ior(best[0], best[1]), to_ior(best[2], best[3])


def any_hit_hybrid(scene, ro: V3, rd: V3, distance, settings):
    """Shadow test of a CSG scene whose operands are all analytic: the
    any-hit over everything else, or any surviving operand slot in
    [0, distance) (the scene's list holds the CSG's filtered output)."""
    hit = any_hit_soa(scene, ro, rd, distance, settings, skip_members=True)
    ts, _, keeps = _member_slots_filtered_nosort(scene, ro, rd)
    for t, keep in zip(ts, keeps):
        hit = hit | (keep & (t >= 0.0) & (t < distance))
    return hit


def any_hit_sorted_soa(scene, ro: V3, rd: V3, distance, settings):
    """Shadow test over the CSG-filtered sorted slots (scene.rs:234-245),
    meshes included."""
    if scene.counts[6]:
        slots = sorted_slots_full_soa(scene, ro, rd, settings)
    else:
        slots = sorted_slots_soa(scene, ro, rd)
    t, _, valid = apply_csg_soa(scene, slots)[:3]
    return (valid & (t >= 0.0) & (t < distance[None, :])).any(dim=0)
