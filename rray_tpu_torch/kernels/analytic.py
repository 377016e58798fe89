"""Area-light soft shadows over analytic occluders: CUDA kernel, plain
PyTorch version, and the wrapper that picks between them; and the
analytic shadow predicate.

Port of rray_tpu's Pallas kernel `rray_tpu/kernels/analytic.py::
area_shadow_fraction` (ROADMAP B5): for each shadow origin, the share of
an area light's level^2 jittered samples (light.rs:47-65,
scene.rs:181-214) that some analytic prim blocks. The torch fast node
calls it for area lights in scenes without a mesh, with the prim rows
and their padded world boxes built once per scene (`scene_occluders`).
The CUDA source is kernels/csrc/area.cu: one thread per origin,
prim-major over chunks of 16 samples (`area_count`),
skipping a bounded prim whose box misses the box of the origin and the
light (a conservative cull: the count is the same), the prims' rows in
shared memory (in global memory past 327 prims, so any number of prims
runs in the kernel).

One deliberate difference from the TPU kernel's signature: it reads a
[2n, R] draw array, while this function takes the int32 seed and draws
from the point-keyed hash of ops/jitter.py (the kernel hashes in
registers). The function is the same: the shadowed fraction of the
points for that seed, equal to rray_tpu's XLA loop fed the same seed.
Both the kernel and the plain version count, then divide by n once
(`count / n`, as rray_tpu's caller divides outside its kernel).

`_occludes` is the predicate both area kernels and the whitted kernel's
shadow rays use; its CUDA form is `occludes` in
kernels/csrc/whitted_device.cuh.
"""
from __future__ import annotations

import functools
import math

import torch

from ..ops import jitter, soa
from ..ops.vec import V3, div
from ..scene import data as sd

OCCLUSION_KINDS = (sd.SPHERE, sd.PLANE, sd.CUBE, sd.CYLINDER, sd.CONE)
N_PARAMS = 16  # 12 affine + up to 3 extras, padded
N_BOUNDS = 8   # lo xyz, hi xyz, bounded, padding
BOUND_PAD = 1e-4  # relative padding of the occluders' world boxes

# Kernel launches made by `area_shadow_fraction` in this process (CPU
# calls, which run the plain version, do not count).
launches = 0


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


def occlusion_params(scene, pids):
    """[len(pids), 16] parameter rows (rray_tpu soa.py _occlusion_params):
    the world->object affine (12), then ymin/ymax/closed for cylinders
    and cones, zeros elsewhere; in the scene's dtype."""
    rows = []
    zero = torch.zeros(N_PARAMS - 12, dtype=scene.dtype, device=scene.device)
    for pid in pids:
        kind = scene.prim_kinds[pid]
        row = scene.prim_rows_static[pid]
        if kind not in OCCLUSION_KINDS:
            raise ValueError(f"prim {pid} of kind {kind} is no analytic "
                             "occluder")
        inv = {sd.SPHERE: scene.sph_inv, sd.PLANE: scene.pla_inv,
               sd.CUBE: scene.cub_inv, sd.CYLINDER: scene.cyl_inv,
               sd.CONE: scene.con_inv}[kind][row]
        extra = zero
        if kind in (sd.CYLINDER, sd.CONE):
            lo, hi, closed = ((scene.cyl_min, scene.cyl_max, scene.cyl_closed)
                              if kind == sd.CYLINDER else
                              (scene.con_min, scene.con_max, scene.con_closed))
            extra = torch.cat([torch.stack([
                lo[row], hi[row], closed[row].to(scene.dtype)]), zero[3:]])
        rows.append(torch.cat([inv.reshape(12).to(scene.dtype), extra]))
    return torch.stack(rows)


def occluder_bounds(params, kinds):
    """[P, 8] float32 world boxes of the occluders from their rows: lo
    xyz, hi xyz (the object-space extent through the inverse of the
    row's affine, in float64, padded by BOUND_PAD * max(1, |x|), far
    more than float32 rounds), then 1 for a bounded prim (sphere, cube,
    cylinder or cone with finite ends), 0 for the rest (planes), whose
    box is never read."""
    p = params.detach().to("cpu", torch.float64)
    out = torch.zeros((len(kinds), N_BOUNDS), dtype=torch.float64)
    for k, kind in enumerate(kinds):
        y0, y1 = float(p[k, 12]), float(p[k, 13])
        m = max(abs(y0), abs(y1))
        ext = {sd.SPHERE: ((-1.0, 1.0),) * 3, sd.CUBE: ((-1.0, 1.0),) * 3,
               sd.CYLINDER: ((-1.0, 1.0), (y0, y1), (-1.0, 1.0)),
               sd.CONE: ((-m, m), (y0, y1), (-m, m))}.get(kind)
        if ext is None or not all(map(math.isfinite, sum(ext, ()))):
            continue
        affine = p[k, :12].reshape(3, 4)
        inv = torch.linalg.inv(affine[:, :3])
        corners = torch.tensor([[x, y, z] for x in ext[0] for y in ext[1]
                                for z in ext[2]], dtype=torch.float64)
        world = (corners - affine[:, 3]) @ inv.T
        pad = BOUND_PAD * torch.clamp_min(world.abs().amax(0), 1.0)
        out[k, :3] = world.amin(0) - pad
        out[k, 3:6] = world.amax(0) + pad
        out[k, 6] = 1.0
    return out.float().to(params.device)


def scene_occluders(scene):
    """The scene's prims as the area-shadow kernel takes them: ([P, 16]
    rows of `occlusion_params`, the P kinds, [P, 8] `occluder_bounds`),
    built once per scene from its detached tensors (occlusion is a 0/1
    outcome: no gradient goes through it)."""
    def make():
        with torch.no_grad():
            params = occlusion_params(scene, range(len(scene.prim_kinds)))
        kinds = tuple(scene.prim_kinds)
        return params, kinds, occluder_bounds(params, kinds)

    return scene.cached("occluders", make)


@functools.lru_cache(maxsize=16)
def _kinds_on(kinds, device):
    """The kinds as an int32 tensor on `device`, once per kinds tuple."""
    return torch.tensor(kinds, dtype=torch.int32, device=device)


def area_sample(cuv, hb, s, level: int, over: V3):
    """Sample s of an area light's level x level jittered grid
    (light.rs:47-65; rray_tpu whitted.py:1149-1163, integrator.py
    :122-136): the segment from `over` to the sample as (unit direction
    V3, length). cuv: corner, uvec, vvec (9 numbers); hb: the origins'
    hash base (ops/jitter.py point_base); s: the sample index, an int or
    an int64 tensor like hb. The kernels' `area_sample`
    (csrc/whitted_device.cuh) writes the same expressions."""
    dtype = over.x.dtype
    r0 = jitter.draw_unit(hb, 2 * s, dtype)
    r1 = jitter.draw_unit(hb, 2 * s + 1, dtype)
    ur = div(s % level + r0, level)
    vr = div(s // level + r1, level)
    seg = V3(cuv[0] + cuv[3] * ur + cuv[6] * vr - over.x,
             cuv[1] + cuv[4] * ur + cuv[7] * vr - over.y,
             cuv[2] + cuv[5] * ur + cuv[8] * vr - over.z)
    dist = torch.sqrt(seg.x * seg.x + seg.y * seg.y + seg.z * seg.z)
    return seg * (1.0 / torch.clamp_min(dist, 1e-30)), dist


def area_shadow_fraction_reference(over_comps, seed: int, light_params,
                                   prim_params, kinds, level: int,
                                   bounds=None):
    """Plain PyTorch version of `area_shadow_fraction` (the sample loop
    of rray_tpu integrator.py:107-148, one sample per step; the count is
    an exact integer sum in any order). It tests every prim: `bounds`
    only let the kernel skip work."""
    over = V3(*over_comps)
    hb = jitter.point_base(seed, over.x, over.y, over.z)
    cuv = light_params.tolist()
    params = prim_params.tolist()
    count = torch.zeros_like(over.x)
    for s in range(level * level):
        direction, dist = area_sample(cuv, hb, s, level, over)
        occ = torch.zeros_like(over.x, dtype=torch.bool)
        for kind, p in zip(kinds, params):
            occ = occ | _occludes(kind, p.__getitem__, over.x, over.y,
                                  over.z, direction.x, direction.y,
                                  direction.z, dist)
        count = count + occ.to(over.x.dtype)
    return div(count, level * level)


def _launch(over_comps, seed, light_params, prim_params, kinds, level,
            bounds=None):
    from . import build

    device = over_comps[0].device
    R, P = over_comps[0].shape[0], len(kinds)
    for k, c in enumerate(over_comps):
        build.check_arg(f"origin component {k}", c, (R,), device)
    build.check_arg("light_params", light_params, (9,), device)
    build.check_arg("prim_params", prim_params, (P, N_PARAMS), device)
    if P == 0 or any(k not in OCCLUSION_KINDS for k in kinds):
        raise ValueError(f"the kernel takes one or more analytic sphere/"
                         f"plane/cube/cylinder/cone prims: {kinds}")
    if bounds is None:
        bounds = occluder_bounds(prim_params, kinds)
    build.check_arg("bounds", bounds, (P, N_BOUNDS), device)
    if level < 1 or not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"level={level}, seed={seed}: the kernel takes a "
                         "level >= 1 and an int32 seed")
    kinds_t = _kinds_on(kinds, device)
    frac = torch.empty(R, dtype=torch.float32, device=device)
    ptr = build.ptr
    with torch.cuda.device(device):
        rc = build.load_library().area_shadow_launch(
            *(ptr(c) for c in over_comps), ptr(light_params),
            ptr(prim_params), ptr(bounds), ptr(kinds_t), P, level, int(seed),
            ptr(frac), R, build.stream(device))
    build.check_launch("area_shadow_fraction", rc)
    build.count(globals(), "launches")
    return frac


def area_shadow_fraction(over_comps, seed: int, light_params, prim_params,
                         kinds, level: int, bounds=None):
    """Shadowed fraction over level^2 jittered samples -> [R].

    over_comps: 3-tuple of [R] shadow origins; seed: the int32 jitter
    seed (ops/jitter.py seed_table); light_params: [9] corner, uvec,
    vvec; prim_params: [P, 16] rows of `occlusion_params`; kinds: the P
    prim kinds (OCCLUSION_KINDS); bounds: their `occluder_bounds` (made
    here when not given). CPU tensors run the plain version; CUDA
    tensors launch the kernel (float32 only)."""
    if over_comps[0].device.type == "cpu":
        return area_shadow_fraction_reference(over_comps, seed, light_params,
                                              prim_params, kinds, level)
    return _launch(over_comps, seed, light_params, prim_params, tuple(kinds),
                   level, bounds)
