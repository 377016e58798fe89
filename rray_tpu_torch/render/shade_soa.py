"""SoA shading for the torch fast node: the class reader, normals and
cheap pattern trees (rray_tpu render/shade_soa.py).

Per-hit shade state comes from the [M] class table (every analytic leaf
is its own class; a mesh's triangles share one): each column is a
select chain over the M classes, exact, with no [R]-sized gathers.
Texture uv mappings, Perlin noise and the torus normal are ROADMAP B1e;
the fast node refuses scenes that need them.
"""
from __future__ import annotations

import torch

from ..config import EPSILON
from ..ops.soa import Hit
from ..ops.vec import V3
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
    winners take the kernel-interpolated vertex normal `hit.tri_n`."""
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

    world_n = apply_gathered_linear(reader.nmat(), n).normalize()
    if sd.TRIANGLE in present:
        tri_n = V3(*hit.tri_n).normalize()
        m = ptype == sd.TRIANGLE
        world_n = V3(torch.where(m, tri_n.x, world_n.x),
                     torch.where(m, tri_n.y, world_n.y),
                     torch.where(m, tri_n.z, world_n.z))
    return world_n


def _apply_inv(inv, p: V3) -> V3:
    """Pattern-node [3,4] inverse."""
    return V3(inv[0, 0] * p.x + inv[0, 1] * p.y + inv[0, 2] * p.z + inv[0, 3],
              inv[1, 0] * p.x + inv[1, 1] * p.y + inv[1, 2] * p.z + inv[1, 3],
              inv[2, 0] * p.x + inv[2, 1] * p.y + inv[2, 2] * p.z + inv[2, 3])


def _even(x):
    return torch.remainder(torch.floor(x), 2.0) == 0.0


def eval_pattern(node: sd.PatternData, pts: V3) -> V3:
    """A cheap pattern tree (material/pattern.rs:145-215) at points."""
    p = _apply_inv(node.inv, pts)
    t = node.ptype
    if t == "solid":
        like = torch.ones_like(p.x)
        return V3(node.color[0] * like, node.color[1] * like,
                  node.color[2] * like)
    a = eval_pattern(node.a, p)
    b = eval_pattern(node.b, p)
    if t == "gradient":
        frac = p.x - torch.floor(p.x)
        return a + (b - a) * frac
    if t == "blend":
        return a * (1.0 - node.scale) + b * node.scale
    if t == "stripe":
        cond = _even(p.x)
    elif t == "ring":
        cond = _even(torch.sqrt(p.x * p.x + p.z * p.z))
    elif t == "checker":
        cond = _even(torch.floor(p.x) + torch.floor(p.y) + torch.floor(p.z))
    else:
        raise ValueError(f"{t!r} is not a cheap pattern")
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def pattern_at(scene: sd.SceneData, hit: Hit, obj_pts: V3,
               reader: ClassReader = None) -> V3:
    """pattern_at_object (material.rs:77-80) on object-space points."""
    if reader is None:
        reader = ClassReader(scene, hit.prim, cls=hit.cls)
    if len(scene.patterns) == 1:
        return eval_pattern(scene.patterns[0], obj_pts)
    pid = reader.icol(sd.CLS_PATTERN)
    zero = torch.zeros_like(obj_pts.x)
    out = V3(zero, zero, zero)
    for i, root in enumerate(scene.patterns):
        m = pid == i
        color = eval_pattern(root, obj_pts)
        out = V3(torch.where(m, color.x, out.x), torch.where(m, color.y, out.y),
                 torch.where(m, color.z, out.z))
    return out
