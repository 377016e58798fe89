"""SoA shading for the torch fast node: the class reader, normals, uv
mappings, textures and pattern trees (rray_tpu render/shade_soa.py).

Per-hit shade state comes from the [M] class table (every analytic leaf
is its own class; a mesh's triangles share one): each column is a
select chain over the M classes, exact, with no [R]-sized gathers.
"""
from __future__ import annotations

import math

import torch

from ..config import EPSILON
from ..ops import noise
from ..ops.soa import Hit
from ..ops.vec import V3, div
from ..scene import data as sd


def _present_types(scene):
    ns, npl, ncu, ncy, nco, nto, T, _ = scene.counts
    return {code for code, n in ((sd.SPHERE, ns), (sd.PLANE, npl),
                                 (sd.CUBE, ncu), (sd.CYLINDER, ncy),
                                 (sd.CONE, nco), (sd.TORUS, nto),
                                 (sd.TRIANGLE, T)) if n}


class ClassReader:
    """Per-hit shade-table reads over the [M] class domain; columns are
    memoized."""

    def __init__(self, scene, prim, cls=None):
        self._tbl = scene.cls_table
        self._M = max(scene.n_classes, 1)
        if cls is None:
            cls = scene.prim_class[prim]
        self._masks = [cls == m for m in range(self._M)]
        self._cols = {}

    def col(self, c):
        """Column c per ray -> [R] (scene dtype)."""
        if c not in self._cols:
            tbl = self._tbl
            acc = torch.where(self._masks[0], tbl[0, c],
                              torch.zeros((), dtype=tbl.dtype,
                                          device=tbl.device))
            for m in range(1, self._M):
                acc = torch.where(self._masks[m], tbl[m, c], acc)
            self._cols[c] = acc
        return self._cols[c]

    def icol(self, c):
        return self.col(c).to(torch.int32)

    def affine_inv(self):
        """world->object affine as a 3x4 nested tuple of [R]."""
        return tuple(tuple(self.col(sd.CLS_INV + 4 * i + j)
                           for j in range(4)) for i in range(3))

    def nmat(self):
        """normal matrix as a 3x3 nested tuple of [R]."""
        return tuple(tuple(self.col(sd.CLS_NMAT + 3 * i + j)
                           for j in range(3)) for i in range(3))


def apply_gathered_point(m, p: V3) -> V3:
    return V3(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
              m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
              m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])


def apply_gathered_linear(m, v: V3) -> V3:
    return V3(m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
              m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
              m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z)


def normal_at(scene: sd.SceneData, hit: Hit, world_pt: V3, lp: V3 = None,
              reader: ClassReader = None) -> V3:
    """World-space unit normal (before the eye-facing flip). Triangle
    winners take the kernel-interpolated vertex normal `hit.tri_n`, or
    without it the vertex normals interpolated at the hit's (u, v)."""
    present = _present_types(scene)
    if reader is None:
        reader = ClassReader(scene, hit.prim, cls=hit.cls)
    if lp is None:
        lp = apply_gathered_point(reader.affine_inv(), world_pt)
    ptype = reader.icol(sd.CLS_TYPE)
    x, y, z = lp.x, lp.y, lp.z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    n = V3(zero, zero, zero)

    def merge(code, cand: V3) -> V3:
        m = ptype == code
        return V3(torch.where(m, cand.x, n.x), torch.where(m, cand.y, n.y),
                  torch.where(m, cand.z, n.z))

    if sd.SPHERE in present:
        n = merge(sd.SPHERE, lp)
    if sd.PLANE in present:
        n = merge(sd.PLANE, V3(zero, one, zero))
    if sd.CUBE in present:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        maxc = torch.maximum(ax, torch.maximum(ay, az))
        n = merge(sd.CUBE, V3(torch.where(maxc == ax, x, zero),
                              torch.where((maxc != ax) & (maxc == ay), y,
                                          zero),
                              torch.where((maxc != ax) & (maxc != ay), z,
                                          zero)))
    for kind in (sd.CYLINDER, sd.CONE):
        if kind not in present:
            continue
        cmin = reader.col(sd.CLS_PMIN)
        cmax = reader.col(sd.CLS_PMAX)
        dist = x * x + z * z
        side = zero
        if kind == sd.CONE:
            side = torch.sqrt(torch.clamp_min(dist, 0.0))
            side = torch.where(y > 0.0, -side, side)
        top = (dist < 1.0) & (y >= cmax - EPSILON)
        bot = (dist < 1.0) & (y <= cmin + EPSILON)
        n = merge(kind, V3(torch.where(top | bot, zero, x),
                           torch.where(top, one, torch.where(bot, -one, side)),
                           torch.where(top | bot, zero, z)))
    if sd.TORUS in present:
        r = reader.col(sd.CLS_TORR)
        ss = x * x + y * y + z * z
        ps = 1.0 + r * r
        n = merge(sd.TORUS, V3(4.0 * x * (ss - ps), 4.0 * y * (ss - ps),
                               4.0 * z * (ss - ps + 2.0)))

    world_n = apply_gathered_linear(reader.nmat(), n).normalize()
    if sd.TRIANGLE in present:
        if hit.tri_n is not None:
            tri_n = V3(*hit.tri_n).normalize()
        else:
            # Sorted slots carry (u, v, tri), not the kernels' normal:
            # interpolate the vertex normals (flat triangles store
            # n1 = n2 = n3), rray_tpu shade_soa.py:178-190.
            tri = hit.tri.long()

            def tv3(table):
                return V3(table[tri, 0], table[tri, 1], table[tri, 2])

            tri_n = (tv3(scene.tri_n2) * hit.u + tv3(scene.tri_n3) * hit.v
                     + tv3(scene.tri_n1) * (1.0 - hit.u - hit.v)).normalize()
        m = ptype == sd.TRIANGLE
        world_n = V3(torch.where(m, tri_n.x, world_n.x),
                     torch.where(m, tri_n.y, world_n.y),
                     torch.where(m, tri_n.z, world_n.z))
    return world_n


def _has_image(node) -> bool:
    return node is not None and (node.ptype == "image" or _has_image(node.a)
                                 or _has_image(node.b))


def _textured_kinds(scene):
    """Shape kinds whose pattern tree holds an image leaf (static): only
    those need a uv mapping (pattern.rs:209-213)."""
    return {kind for pid, kind in zip(scene.prim_pattern_static,
                                      scene.prim_kinds)
            if pid < len(scene.patterns) and _has_image(scene.patterns[pid])}


def uv_at(scene: sd.SceneData, hit: Hit, pts: V3, reader: ClassReader,
          kinds=None):
    """Per-shape uv_mapping on pattern-space points (rray_tpu
    shade_soa.py:227-314). `kinds` restricts it to those shape kinds;
    rays on other kinds get (0, 0)."""
    present = _present_types(scene)
    if kinds is not None:
        present = present & kinds
    ptype = reader.icol(sd.CLS_TYPE)
    x, y, z = pts.x, pts.y, pts.z
    pi = math.pi
    u = torch.zeros_like(x)
    v = torch.zeros_like(x)

    def merge(code, uu, vv):
        m = ptype == code
        return torch.where(m, uu, u), torch.where(m, vv, v)

    def turn(angle):  # (angle + pi) / 2pi, rounded once on every device
        return div(angle + pi, 2.0 * pi)

    if sd.SPHERE in present:
        theta = torch.atan2(z, x)
        rr = torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        phi = torch.acos(torch.clamp(y / rr, -1.0, 1.0))
        u, v = merge(sd.SPHERE, turn(theta), 1.0 - div(phi, pi))
    if sd.PLANE in present:
        u, v = merge(sd.PLANE, torch.remainder(x, 1.0),
                     torch.remainder(z, 1.0))
    if sd.CUBE in present:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        fx = (ax >= ay) & (ax >= az)
        fy = ~fx & (ay >= ax) & (ay >= az)
        ur = torch.where(x > 0, (z + 1.0) * 0.5, (1.0 - z) * 0.5)
        uy = (x + 1.0) * 0.5
        vy = torch.where(y > 0, (1.0 - z) * 0.5, (z + 1.0) * 0.5)
        uz = torch.where(z > 0, (x + 1.0) * 0.5, (1.0 - x) * 0.5)
        u, v = merge(sd.CUBE, torch.where(fx, ur, torch.where(fy, uy, uz)),
                     torch.where(fy, vy, (y + 1.0) * 0.5))
    if sd.CYLINDER in present:
        cmin, cmax = reader.col(sd.CLS_PMIN), reader.col(sd.CLS_PMAX)
        closed = reader.col(sd.CLS_CLOSED) != 0.0
        cap = closed & ((y <= cmin) | (y >= cmax))
        theta = torch.atan2(z, x)
        u, v = merge(sd.CYLINDER,
                     torch.where(cap, (x + 1.0) / 2.0, turn(theta)),
                     torch.where(cap, (z + 1.0) / 2.0,
                                 torch.remainder(y, 1.0)))
    if sd.CONE in present:
        cmin, cmax = reader.col(sd.CLS_PMIN), reader.col(sd.CLS_PMAX)
        closed = reader.col(sd.CLS_CLOSED) != 0.0
        cap = closed & ((torch.abs(y - cmin) <= EPSILON)
                        | (torch.abs(y - cmax) <= EPSILON))
        radius = torch.clamp_min(torch.abs(y), 1e-30)
        theta = turn(torch.atan2(z, x))
        height = torch.where(torch.abs(cmax - cmin) < 1e-30,
                             torch.full_like(cmax, 1e-30), cmax - cmin)
        # Side uv is (normalized y, theta) (cone.rs:244-253).
        u, v = merge(sd.CONE,
                     torch.where(cap, (x / radius + 1.0) / 2.0,
                                 div(y - cmin, height)),
                     torch.where(cap, (z / radius + 1.0) / 2.0, theta))
    if sd.TORUS in present:
        uu = turn(torch.atan2(y, x))
        dist = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-30)) - 1.0
        u, v = merge(sd.TORUS, uu, turn(torch.atan2(z, dist)))
    if sd.TRIANGLE in present:
        tri = hit.tri.long()

        def tv3(table):
            return V3(table[tri, 0], table[tri, 1], table[tri, 2])

        p1, e1, e2 = tv3(scene.tri_p1), tv3(scene.tri_e1), tv3(scene.tri_e2)
        w = pts - p1
        d00, d01, d11 = e1.dot(e1), e1.dot(e2), e2.dot(e2)
        d20, d21 = w.dot(e1), w.dot(e2)
        denom = d00 * d11 - d01 * d01
        denom = torch.where(torch.abs(denom) < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        u, v = merge(sd.TRIANGLE, (d11 * d20 - d01 * d21) / denom,
                     (d00 * d21 - d01 * d20) / denom)
    return u, v


def _apply_inv(inv, p: V3) -> V3:
    """Pattern-node [3,4] inverse."""
    return V3(inv[0, 0] * p.x + inv[0, 1] * p.y + inv[0, 2] * p.z + inv[0, 3],
              inv[1, 0] * p.x + inv[1, 1] * p.y + inv[1, 2] * p.z + inv[1, 3],
              inv[2, 0] * p.x + inv[2, 1] * p.y + inv[2, 2] * p.z + inv[2, 3])


def _even(x):
    return torch.remainder(torch.floor(x), 2.0) == 0.0


def texel_index(h: int, w: int, uu, vv):
    """Row-major flat texel index of (u, v) (pattern.rs:209-213,
    texture.rs:32-54): clamp to [0, 1], scale, truncate, flip v."""
    uu = torch.clamp(uu, 0.0, 1.0)
    vv = torch.clamp(vv, 0.0, 1.0)
    xi = torch.clamp_max((uu * w).to(torch.int64), w - 1)
    yi = h - 1 - torch.clamp_max((vv * h).to(torch.int64), h - 1)
    return yi * w + xi


def unpack_rgb8(px, dtype) -> V3:
    """Packed 8-bit RGB (scene/data.py) -> the u8 / 255 float values."""
    s = torch.tensor(1.0 / 255.0, dtype=dtype)
    return V3(((px >> 16) & 0xFF).to(dtype) * s,
              ((px >> 8) & 0xFF).to(dtype) * s, (px & 0xFF).to(dtype) * s)


def fetch_texel_flat(texture, flat, dtype) -> V3:
    """Texel by flat row-major index: packed RGB8 (int32 [H, W]) or float
    [H, W, 3] textures."""
    if texture.dtype == torch.int32:
        return unpack_rgb8(texture.reshape(-1)[flat], dtype)
    rgb = texture.reshape(-1, 3)[flat]
    return V3(rgb[:, 0], rgb[:, 1], rgb[:, 2])


def sample_texture(texture, uu, vv) -> V3:
    h, w = texture.shape[0], texture.shape[1]
    return fetch_texel_flat(texture, texel_index(h, w, uu, vv), uu.dtype)


def eval_pattern(node: sd.PatternData, pts: V3, uv_ctx=None) -> V3:
    """A pattern tree (material/pattern.rs:145-215) at points; `uv_ctx`
    maps pattern-space points to (u, v) for image leaves."""
    p = _apply_inv(node.inv, pts)
    t = node.ptype
    if t == "solid":
        like = torch.ones_like(p.x)
        return V3(node.color[0] * like, node.color[1] * like,
                  node.color[2] * like)
    if t == "test":
        return p
    if t == "perturbed":
        oc, pe = node.octaves, node.persistence
        nx = noise.octave_perlin(p.x, p.y, p.z, oc, pe) * node.scale
        ny = noise.octave_perlin(p.x, p.y, p.z + 1.0, oc, pe) * node.scale
        nz = noise.octave_perlin(p.x, p.y, p.z + 2.0, oc, pe) * node.scale
        return eval_pattern(node.a, p + V3(nx, ny, nz), uv_ctx)
    if t == "image":
        uu, vv = uv_ctx(p)
        return sample_texture(node.texture, uu, vv)
    a = eval_pattern(node.a, p, uv_ctx)
    b = eval_pattern(node.b, p, uv_ctx)
    if t == "gradient":
        frac = p.x - torch.floor(p.x)
        return a + (b - a) * frac
    if t == "blend":
        return a * (1.0 - node.scale) + b * node.scale
    if t == "noise":
        n = noise.octave_perlin(p.x, p.y, p.z, node.octaves,
                                node.persistence) * node.scale
        neg = n <= 0.0
        return V3(torch.where(neg, a.x * -n, b.x * n),
                  torch.where(neg, a.y * -n, b.y * n),
                  torch.where(neg, a.z * -n, b.z * n))
    if t == "stripe":
        cond = _even(p.x)
    elif t == "ring":
        cond = _even(torch.sqrt(p.x * p.x + p.z * p.z))
    elif t == "checker":
        cond = _even(torch.floor(p.x) + torch.floor(p.y) + torch.floor(p.z))
    else:
        raise ValueError(f"unknown pattern type {t!r}")
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def pattern_at(scene: sd.SceneData, hit: Hit, obj_pts: V3,
               reader: ClassReader = None) -> V3:
    """pattern_at_object (material.rs:77-80) on object-space points."""
    if reader is None:
        reader = ClassReader(scene, hit.prim, cls=hit.cls)
    kinds = _textured_kinds(scene)

    def uv_ctx(pattern_pts):
        return uv_at(scene, hit, pattern_pts, reader, kinds)

    if len(scene.patterns) == 1:
        return eval_pattern(scene.patterns[0], obj_pts, uv_ctx)
    pid = reader.icol(sd.CLS_PATTERN)
    zero = torch.zeros_like(obj_pts.x)
    out = V3(zero, zero, zero)
    for i, root in enumerate(scene.patterns):
        m = pid == i
        if not bool(m.any()):
            continue  # a tree no ray hit: its values would be masked out
        color = eval_pattern(root, obj_pts, uv_ctx)
        out = V3(torch.where(m, color.x, out.x), torch.where(m, color.y, out.y),
                 torch.where(m, color.z, out.z))
    return out
