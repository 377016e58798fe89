"""The analytic shadow predicate (rray_tpu kernels/analytic.py `_occludes`).

Only the helper that the Whitted kernel's shadow rays use is ported
here; the area-light sample-loop kernel (`area_shadow_fraction`) is
ROADMAP item B5. The CUDA form of this predicate is `occludes` in
kernels/csrc/whitted.cu.
"""
from __future__ import annotations

import torch

from ..ops import soa
from ..ops.vec import V3
from ..scene import data as sd

OCCLUSION_KINDS = (sd.SPHERE, sd.PLANE, sd.CUBE, sd.CYLINDER, sd.CONE)


def _occludes(kind, p, ox, oy, oz, dx, dy, dz, dist):
    """Does prim (kind, param reader p) block [0, dist) on the ray?

    Rays are WORLD-space [R] tensors; p(0..11) is the world->object
    affine, p(12..14) the ymin/ymax/closed extras (Python numbers)."""
    o = V3(p(0) * ox + p(1) * oy + p(2) * oz + p(3),
           p(4) * ox + p(5) * oy + p(6) * oz + p(7),
           p(8) * ox + p(9) * oy + p(10) * oz + p(11))
    d = V3(p(0) * dx + p(1) * dy + p(2) * dz,
           p(4) * dx + p(5) * dy + p(6) * dz,
           p(8) * dx + p(9) * dy + p(10) * dz)
    if kind == sd.SPHERE:
        return soa._sphere_occludes_local(o, d, dist)
    if kind == sd.PLANE:
        return soa._plane_occludes_local(o, d, dist)
    if kind == sd.CUBE:
        slots = soa._cube_slots(o, d)
    elif kind == sd.CYLINDER:
        slots = soa._cylinder_slots(o, d, p(12), p(13), p(14) != 0.0)
    elif kind == sd.CONE:
        slots = soa._cone_slots(o, d, p(12), p(13), p(14) != 0.0)
    else:
        raise ValueError(f"unsupported occluder kind {kind}")
    hit = torch.zeros_like(dist, dtype=torch.bool)
    for t, valid in slots:
        hit = hit | (valid & (t >= 0.0) & (t < dist))
    return hit
