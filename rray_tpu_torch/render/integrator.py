"""The Whitted integrator: camera rays through the whole-tree kernel or
the torch fast node.

rray_tpu's render() picks a node per scene: XLA for point-light scenes
with only analytic prims and cheap patterns, and for reflective mesh
scenes (TPU speed choices), the fused Pallas kernel for the rest that
kernels/whitted.py::applicable accepts, XLA scans otherwise. The port
runs every scene that the whitted kernel accepts through the kernel;
both of rray_tpu's routes compute the same image. Scenes the kernel
rejects go to the torch fast node, rray_tpu's `_color_at_soa_xla`
(no CSG, no transparency; tori, Perlin noise and textures included),
whose triangle tests run in the triangle and BVH kernels and whose
area-light shadows run in the area-shadow kernel (kernels/analytic.py)
when the scene has no mesh and no torus. Scenes neither takes (a CSG or
transparency the kernel rejects) raise NotImplementedError naming the
ROADMAP item that will carry them.

Area lights draw their jitter from rray_tpu's key chain: level l of the
Whitted chain and light li use seed_table(seed)[l, li] (ops/jitter.py),
the seed that rray_tpu derives from fold_in(fold_in(PRNGKey(seed), l),
1000 + li) on both of its routes.
"""
from __future__ import annotations

import torch

from ..config import RenderSettings, offset_eps
from ..kernels import analytic, whitted
from ..ops import jitter, soa
from ..ops.vec import V3, div
from ..scene import data as sd
from ..scene.data import SceneData
from . import shade_soa
from .camera import CameraData, all_rays_soa


def fast_unsupported(scene) -> str | None:
    """Why the torch fast node cannot render this scene, naming the
    ROADMAP item that will carry it — or None when it can."""
    if scene.csg_ops:
        return ("CSG scenes the whitted kernel rejects: ROADMAP A10 (the "
                "sorted torch node)")
    if scene.has_transparent:
        return ("transparency outside the whitted kernel: ROADMAP A6 and "
                "A10 (the sorted torch node)")
    return None


def route(scene) -> str:
    """"kernel" (the whitted kernel) or "fast" (the torch fast node);
    raises NotImplementedError for scenes neither renders yet."""
    if whitted.applicable(scene):
        return "kernel"
    reason = fast_unsupported(scene)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")
    return "fast"


# ---------------------------------------------------------------------------
# The torch fast node (rray_tpu integrator.py:49-295).
# ---------------------------------------------------------------------------

def _shadow_fraction_soa(scene, light, over: V3, settings, seed: int):
    """Point: binary shadow (scene.rs:234-245) as 0/1. Area: the share of
    level^2 jittered-grid samples (scene.rs:181-214, light.rs:47-65)
    that are blocked, count / n, drawn from the point-keyed hash with
    `seed` (rray_tpu integrator.py:57-148)."""
    dtype = over.x.dtype
    if light.kind == "point":
        to_light = V3(light.position[0] - over.x, light.position[1] - over.y,
                      light.position[2] - over.z)
        dist = to_light.norm()
        direction = to_light * (1.0 / torch.clamp_min(dist, 1e-30))
        shadowed = soa.any_hit_soa(scene, over, direction, dist, settings)
        return shadowed.to(dtype)

    level = light.level
    n = level * level
    kinds = scene.prim_kinds
    if (not scene.counts[6] and kinds
            and all(k in analytic.OCCLUSION_KINDS for k in kinds)):
        # The whole sample loop in one kernel (B5), which takes no tori
        # (nor does rray_tpu's); a torus scene takes the loop below.
        params, kinds, bounds = analytic.scene_occluders(scene)
        return analytic.area_shadow_fraction(
            (over.x, over.y, over.z), seed,
            torch.cat([light.corner, light.uvec, light.vvec]), params, kinds,
            level, bounds=bounds)
    # `level` samples per step at [level * R] width, as rray_tpu groups
    # them: each step's any-hit is one triangle or BVH kernel call (one
    # sample per step made area4b's frame twice as long, host-side). The
    # sum of 0/1 samples is exact in any grouping.
    R = over.x.shape[0]
    hb = jitter.point_base(seed, over.x, over.y, over.z).repeat(level)
    over_g = V3(over.x.repeat(level), over.y.repeat(level),
                over.z.repeat(level))
    cuv = torch.cat([light.corner, light.uvec, light.vvec]).tolist()
    acc = torch.zeros_like(over.x)
    for row in range(level):
        s = torch.arange(row * level, (row + 1) * level,
                         device=hb.device).repeat_interleave(R)
        direction, dist = analytic.area_sample(cuv, hb, s, level, over_g)
        shadowed = soa.any_hit_soa(scene, over_g, direction, dist, settings)
        acc = acc + shadowed.to(dtype).reshape(level, R).sum(0)
    return div(acc, n)


def _lighting_soa(reader, base: V3, light, point: V3, eyev: V3,
                  normalv: V3, shadow_frac):
    """Phong (light.rs:98-140), material columns from the class reader."""
    li = light.intensity
    effective = V3(base.x * li[0], base.y * li[1], base.z * li[2])
    lightv = V3(light.position[0] - point.x, light.position[1] - point.y,
                light.position[2] - point.z).normalize()
    ambient = effective * reader.col(sd.CLS_AMBIENT)
    ldn = lightv.dot(normalv)
    lit = ldn >= 0.0
    dscale = torch.where(lit, reader.col(sd.CLS_DIFFUSE) * ldn, 0.0)
    rde = (-lightv).reflect(normalv).dot(eyev)
    spec_on = lit & (rde > 0.0)
    factor = torch.pow(torch.clamp_min(rde, 1e-30),
                       reader.col(sd.CLS_SHININESS))
    sscale = torch.where(spec_on, reader.col(sd.CLS_SPECULAR) * factor, 0.0)
    unshadow = 1.0 - shadow_frac
    return V3(
        ambient.x + (effective.x * dscale + li[0] * sscale) * unshadow,
        ambient.y + (effective.y * dscale + li[1] * sscale) * unshadow,
        ambient.z + (effective.z * dscale + li[2] * sscale) * unshadow)


def _fast_node_eval(scene: SceneData, ro: V3, rd: V3,
                    settings: RenderSettings, seeds):
    """One fast-path node: closest hit and full surface shade ->
    (surface masked by found, over point, reflect direction, reflect
    weight masked by found). `seeds` holds this level's jitter seed per
    light."""
    hit = soa.closest_hit_soa(scene, ro, rd, settings)
    found = hit.found
    point = ro + rd * torch.where(found, hit.t, 0.0)
    eyev = -rd
    reader = shade_soa.ClassReader(scene, hit.prim, cls=hit.cls)
    aff = reader.affine_inv()
    lp = shade_soa.apply_gathered_point(aff, point)
    normalv = shade_soa.normal_at(scene, hit, point, lp, reader=reader)
    inside = normalv.dot(eyev) < 0.0
    normalv = normalv * torch.where(inside, -1.0, 1.0).to(ro.x.dtype)
    over = point + normalv * offset_eps(ro.x.dtype)
    # The pattern is evaluated at the over point (scene.rs:165).
    base = shade_soa.pattern_at(
        scene, hit, shade_soa.apply_gathered_point(aff, over), reader=reader)
    zero = torch.zeros_like(point.x)
    surface = V3(zero, zero, zero)
    for light, seed in zip(scene.lights, seeds):
        frac = _shadow_fraction_soa(scene, light, over, settings, seed)
        surface = surface + _lighting_soa(reader, base, light, over, eyev,
                                          normalv, frac)
    surface = V3(torch.where(found, surface.x, 0.0),
                 torch.where(found, surface.y, 0.0),
                 torch.where(found, surface.z, 0.0))
    refl = torch.where(found, reader.col(sd.CLS_REFLECTIVE), 0.0)
    return surface, over, rd.reflect(normalv), refl


def color_at_fast(scene: SceneData, ro: V3, rd: V3, remaining: int,
                  settings: RenderSettings, seeds) -> V3:
    """Surface plus the width-1 reflection chain (rray_tpu
    _color_at_soa_xla). A level runs only while some weight is nonzero;
    chains die when a bounce lands on a non-reflective surface. Level l
    draws its area-light jitter with seeds[l] (the [remaining + 1, L]
    table of ops/jitter.py seed_table)."""
    seeds = seeds.tolist()
    if remaining == 0 or not scene.has_reflective:
        return _fast_node_eval(scene, ro, rd, settings, seeds[0])[0]
    zero = torch.zeros_like(ro.x)
    acc = V3(zero, zero, zero)
    weights = torch.ones_like(ro.x)
    for level in range(remaining + 1):
        if not bool((weights != 0.0).any()):
            break
        surface, over, reflectv, refl = _fast_node_eval(
            scene, ro, rd, settings, seeds[level])
        acc = acc + surface * weights
        ro, rd, weights = over, reflectv, weights * refl
    return acc


def render(scene: SceneData, cam: CameraData,
           settings: RenderSettings = RenderSettings(), seed: int = 0):
    """Full-frame render -> image [vsize, hsize, 3] (linear, unclamped),
    on the scene's device. `seed` keys the area lights' jitter, as
    rray_tpu's render(seed=...) does."""
    node = route(scene)
    ro, rd = all_rays_soa(cam)
    if node == "kernel":
        # The raster width lets the kernel shade the rays in pixel tiles.
        rgb = whitted.whitted_compact(
            (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z),
            **whitted.kernel_inputs(scene, settings, seed), width=cam.hsize)
    else:
        out = color_at_fast(scene, ro, rd, settings.depth, settings,
                            jitter.seed_table(seed, settings.depth,
                                              len(scene.lights)))
        rgb = (out.x, out.y, out.z)
    return torch.stack(rgb, dim=-1).reshape(cam.vsize, cam.hsize, 3)
