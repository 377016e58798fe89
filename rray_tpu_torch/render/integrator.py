"""The Whitted integrator: camera rays through the whole-tree kernel or
the torch fast node.

rray_tpu's render() picks a node per scene: XLA for point-light scenes
with only analytic prims and cheap patterns, and for reflective mesh
scenes (TPU speed choices), the fused Pallas kernel for the rest that
kernels/whitted.py::applicable accepts, XLA scans otherwise. The port
runs every scene that the whitted kernel accepts through the kernel;
both of rray_tpu's routes compute the same image. Scenes the kernel
rejects go to the torch fast node, rray_tpu's `_color_at_soa_xla`
(no CSG, no transparency, point lights, cheap patterns), whose triangle
tests run in the triangle and BVH kernels. Scenes neither takes yet
raise NotImplementedError naming the ROADMAP item that will carry them.
"""
from __future__ import annotations

import torch

from ..config import RenderSettings, offset_eps
from ..kernels import whitted
from ..ops import soa
from ..ops.vec import V3
from ..scene import data as sd
from ..scene.data import SceneData
from . import shade_soa
from .camera import CameraData, all_rays_soa


def fast_unsupported(scene) -> str | None:
    """Why the torch fast node cannot render this scene, naming the
    ROADMAP item that will carry it — or None when it can."""
    reason = whitted.unported(scene)
    if reason is not None:
        return reason
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
# The torch fast node (rray_tpu integrator.py:49-295, point lights).
# ---------------------------------------------------------------------------

def _shadow_fraction_soa(scene, light, over: V3, settings):
    """Binary point-light shadow (scene.rs:234-245) as 0/1."""
    to_light = V3(light.position[0] - over.x, light.position[1] - over.y,
                  light.position[2] - over.z)
    dist = to_light.norm()
    direction = to_light * (1.0 / torch.clamp_min(dist, 1e-30))
    shadowed = soa.any_hit_soa(scene, over, direction, dist, settings)
    return shadowed.to(over.x.dtype)


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
                    settings: RenderSettings):
    """One fast-path node: closest hit and full surface shade ->
    (surface masked by found, over point, reflect direction, reflect
    weight masked by found)."""
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
    for light in scene.lights:
        frac = _shadow_fraction_soa(scene, light, over, settings)
        surface = surface + _lighting_soa(reader, base, light, over, eyev,
                                          normalv, frac)
    surface = V3(torch.where(found, surface.x, 0.0),
                 torch.where(found, surface.y, 0.0),
                 torch.where(found, surface.z, 0.0))
    refl = torch.where(found, reader.col(sd.CLS_REFLECTIVE), 0.0)
    return surface, over, rd.reflect(normalv), refl


def color_at_fast(scene: SceneData, ro: V3, rd: V3, remaining: int,
                  settings: RenderSettings) -> V3:
    """Surface plus the width-1 reflection chain (rray_tpu
    _color_at_soa_xla). A level runs only while some weight is nonzero;
    chains die when a bounce lands on a non-reflective surface."""
    if remaining == 0 or not scene.has_reflective:
        return _fast_node_eval(scene, ro, rd, settings)[0]
    zero = torch.zeros_like(ro.x)
    acc = V3(zero, zero, zero)
    weights = torch.ones_like(ro.x)
    for _ in range(remaining + 1):
        if not bool((weights != 0.0).any()):
            break
        surface, over, reflectv, refl = _fast_node_eval(scene, ro, rd,
                                                        settings)
        acc = acc + surface * weights
        ro, rd, weights = over, reflectv, weights * refl
    return acc


def render(scene: SceneData, cam: CameraData,
           settings: RenderSettings = RenderSettings()):
    """Full-frame render -> image [vsize, hsize, 3] (linear, unclamped),
    on the scene's device."""
    node = route(scene)
    ro, rd = all_rays_soa(cam)
    if node == "kernel":
        rgb = whitted.whitted_compact(
            (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z),
            **whitted.kernel_inputs(scene, settings))
    else:
        out = color_at_fast(scene, ro, rd, settings.depth, settings)
        rgb = (out.x, out.y, out.z)
    return torch.stack(rgb, dim=-1).reshape(cam.vsize, cam.hsize, 3)
