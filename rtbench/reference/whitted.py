# _dot, _reflect, _normalize, _schlick, _lighting and the point-light branch of _shadow_fraction (point_shadow):
# frozen copies of rray_tpu_torch/render/integrator.py at commit 6dfcb62; node() is its color_at_aos
# without the recursion, and trace() follows its _color_at_compact_scan (same commit) over node().
"""The Whitted tree of the configurations as plain torch ops.

`node` is one evaluation of the port's per-ray (AoS) reference node:
sorted hits (hits.py), normals (normals.py), patterns (patterns.py),
Phong with hard shadows from point lights. `trace` walks the tree level
by level as the port's compact wavefront defines it: with reflection and
refraction both spawning, a pixel keeps at most W = min(max(capacity,
2), 2^depth) paths per level, the W of largest weight (a stable sort,
reflect rows before refract rows, zero weights last); with reflection
alone, one chain of bounces. The per-ray path the port exports as its
oracle keeps every path, so it cannot judge a frame at capacity 4.

The shadow fraction is a seam, chosen by each light's kind. `node`
carries the tree level down to `shadow_fraction(kind)`: `point_shadow`
for a point light, else the function `shadow` of reference/<kind>.py,
(scene, light index, light, over points [R, 3], settings, level) -> [R]
fraction of the light that is blocked. A new kind of light is a new
module alone. Frames render under the port's default seed, 0, so a
module that replays the port's random numbers takes that seed, as
area.py does for area lights. A kind that no module gives is refused.

Scenes with refraction but no reflection are refused: no configuration
of the benchmark has them yet.
"""
from __future__ import annotations

import importlib

import torch

from . import data as sd
from . import hits, normals, patterns
from .camera import Camera, compile_camera, rays_for_pixels
from .rconfig import RenderSettings, offset_eps


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _reflect(v, n):
    return v - n * (2.0 * _dot(v, n))[:, None]


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-30)


def _schlick(eyev, normalv, n1, n2):
    cos = _dot(eyev, normalv)
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-30))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_eff) ** 5
    tir = (n1 > n2) & (sin2_t > 1.0)
    return torch.where(tir, 1.0, reflectance)


def _lighting(scene, prim, base_color, light, point, eyev, normalv,
              shadow_frac):
    effective = base_color * light.intensity[None, :]
    lightv = _normalize(light.position[None, :] - point)
    ambient = effective * scene.mat_ambient[prim][:, None]
    ldn = _dot(lightv, normalv)
    lit = ldn >= 0.0
    diffuse = effective * (scene.mat_diffuse[prim] * ldn)[:, None]
    reflectv = _reflect(-lightv, normalv)
    rde = _dot(reflectv, eyev)
    spec_on = lit & (rde > 0.0)
    factor = torch.pow(torch.clamp_min(rde, 1e-30), scene.mat_shininess[prim])
    specular = (light.intensity[None, :]
                * (scene.mat_specular[prim] * factor)[:, None])
    diffuse = torch.where(lit[:, None], diffuse, 0.0)
    specular = torch.where(spec_on[:, None], specular, 0.0)
    return ambient + (diffuse + specular) * (1.0 - shadow_frac)[:, None]


def point_shadow(scene, li, light, over, settings, level):
    """The fraction of a point light that is blocked at `over` [R, 3]:
    one hard shadow ray, 0 or 1 (`li` and `level` unused)."""
    v = light.position[None, :] - over
    dist = torch.linalg.norm(v, dim=-1)
    direction = v / torch.clamp_min(dist[:, None], 1e-30)
    return hits.shadow_hit(scene, over, direction, dist,
                           settings).to(over.dtype)


def shadow_fraction(kind: str):
    """The shadow function of a kind of light: point_shadow, or `shadow`
    of reference/<kind>.py."""
    if kind == "point":
        return point_shadow
    try:
        return importlib.import_module(f"{__package__}.{kind}").shadow
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{kind}":
            raise
        raise NotImplementedError(
            f"no reference module gives {kind} lights") from None


def node(scene, ro, rd, settings, level=0):
    """One Whitted node over [R, 3] rays at tree level `level` ->
    (surface [R, 3], zero where nothing is hit; over, under, reflect and
    refract directions [R, 3]; reflect and refract weights [R]). The
    weights carry reflective and transparency, Schlick-blended where a
    material has both."""
    dtype = ro.dtype
    eps = offset_eps(dtype)
    slots = hits.gather_sorted_hits(scene, ro, rd, settings)
    found, hit_idx, t, prim, u, v = hits.select_hit(slots)
    prim = prim.long()

    point = ro + rd * torch.where(found, t, 0.0)[:, None]
    eyev = -rd
    normalv = normals.normal_at(scene, prim, u, v, point)
    inside = _dot(normalv, eyev) < 0.0
    normalv = torch.where(inside[:, None], -normalv, normalv)
    over = point + normalv * eps
    under = point - normalv * eps
    reflectv = _reflect(rd, normalv)
    if scene.has_transparent:
        n1, n2 = hits.refractive_indices(scene, slots, hit_idx,
                                         settings.containers_depth)
    else:
        n1 = n2 = torch.ones_like(t)
    del slots

    base_color = patterns.pattern_at_object(scene, prim, over)
    surface = torch.zeros_like(ro)
    for li, light in enumerate(scene.lights):
        frac = shadow_fraction(light.kind)(scene, li, light, over,
                                           settings, level)
        surface = surface + _lighting(scene, prim, base_color, light, over,
                                      eyev, normalv, frac)
    surface = torch.where(found[:, None], surface, 0.0)

    reflective = torch.where(found, scene.mat_reflective[prim], 0.0)
    transparency = torch.where(found, scene.mat_transparency[prim], 0.0)
    n_ratio = n1 / n2
    cos_i = _dot(eyev, normalv)
    sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-30))
    direction = (normalv * (n_ratio * cos_i - cos_t)[:, None]
                 - eyev * n_ratio[:, None])
    live = found & ~tir & (transparency > 0.0)
    refr_dir = torch.where(live[:, None], direction,
                           torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                        device=ro.device))
    refl_w = reflective
    refr_w = torch.where(live, transparency, 0.0)
    if scene.has_reflective and scene.has_transparent:
        both = (reflective > 0.0) & (transparency > 0.0)
        reflectance = _schlick(eyev, normalv, n1, n2)
        refl_w = torch.where(both, reflective * reflectance, refl_w)
        refr_w = torch.where(both, refr_w * (1.0 - reflectance), refr_w)
    return surface, over, under, reflectv, refr_dir, refl_w, refr_w


def trace(scene, ro, rd, settings):
    """The colour along [R, 3] rays of a canonical scene -> [R, 3]."""
    depth = settings.depth
    if depth > 0 and scene.has_transparent:
        if not scene.has_reflective:
            raise NotImplementedError("refraction without reflection")
        return _compact(scene, ro, rd, settings)
    acc = torch.zeros_like(ro)
    w = torch.ones_like(ro[:, 0])
    for level in range(depth + 1):
        if level and not bool((w != 0.0).any()):
            break
        surface, over, _, reflectv, _, refl_w, _ = node(scene, ro, rd,
                                                        settings, level)
        acc = acc + surface * w[:, None]
        ro, rd, w = over, reflectv, w * refl_w
    return acc


def _compact(scene, ro, rd, settings):
    R = ro.shape[0]
    depth = settings.depth
    W = min(max(int(settings.wavefront_capacity), 2), 2 ** depth)
    acc = torch.zeros_like(ro)
    state = (ro, rd, torch.ones_like(ro[:, 0]))

    def level_eval(state, width, level):
        o, d, wf = state
        surface, over, under, reflectv, refr_dir, refl_w, refr_w = node(
            scene, o, d, settings, level)
        contrib = (surface * wf[:, None]).reshape(width, R, 3).sum(0)
        return contrib, ((over, under), (reflectv, refr_dir),
                         (wf * refl_w, wf * refr_w))

    width, level = 1, 0
    while level <= depth and 2 * width <= W and level < 2:
        if level > 0 and not bool((state[2] != 0.0).any()):
            return acc
        contrib, children = level_eval(state, width, level)
        acc = acc + contrib
        state = tuple(torch.cat(pair) for pair in children)
        width, level = 2 * width, level + 1
    if width < W:  # lift to W rows: zero weights, direction +z
        pad = (W - width) * R
        o, d, wf = state
        up = torch.zeros_like(d[:1]).expand(pad, 3).clone()
        up[:, 2] = 1.0
        state = (torch.cat([o, o.new_zeros((pad, 3))]),
                 torch.cat([d, up]), torch.cat([wf, wf.new_zeros(pad)]))
    for level in range(level, depth + 1):
        if not bool((state[2] != 0.0).any()):
            break
        contrib, children = level_eval(state, W, level)
        acc = acc + contrib
        (o2, d2, w2) = [torch.cat([a.reshape(W, R, -1), b.reshape(W, R, -1)])
                        for a, b in children]
        keys = torch.where(w2[..., 0] == 0.0, 0.0, -w2[..., 0])
        order = torch.sort(keys, dim=0, stable=True).indices[:W]
        pick = lambda a: torch.gather(
            a, 0, order[..., None].expand(W, R, a.shape[-1]))
        state = (pick(o2).reshape(W * R, 3), pick(d2).reshape(W * R, 3),
                 pick(w2).reshape(W * R))
    return acc


def load(yaml_text: str, base_dir: str, dtype=torch.float32, device="cpu"):
    """(camera spec, canonical scene) from a scene's YAML text."""
    from .yaml_loader import load_scene_str

    spec, lights, shapes = load_scene_str(yaml_text, base_dir)
    scene = sd.compile_scene(shapes, lights, dtype=dtype, device=device)
    return spec, sd.canonicalize(scene)


def camera(spec, hsize: int, vsize: int, dtype=torch.float32, device="cpu"):
    cam = Camera(hsize, vsize, spec["fov"])
    cam.transform = spec["transform"]
    return compile_camera(cam, dtype, device)


def pixels(scene, cam, px, py, aa: int, settings: RenderSettings):
    """The AA-downsampled colour [N, 3] of output pixels (px, py) [N]:
    the mean of the aa x aa raster rays each covers (canvas.rs:76-105)."""
    j, i = torch.meshgrid(torch.arange(aa, device=px.device),
                          torch.arange(aa, device=px.device), indexing="ij")
    rx = (px[:, None] * aa + i.reshape(1, -1)).reshape(-1)
    ry = (py[:, None] * aa + j.reshape(1, -1)).reshape(-1)
    ro, rd = rays_for_pixels(cam, rx, ry)
    rgb = trace(scene, ro, rd, settings)
    return rgb.reshape(px.shape[0], aa * aa, 3).mean(dim=1)


def frame_rows(scene, cam, r0: int, r1: int, settings: RenderSettings):
    """Raster rows [r0, r1) at aa = 1 -> [r1 - r0, hsize, 3]."""
    dev = cam.inv.device
    ys, xs = torch.meshgrid(torch.arange(r0, r1, device=dev),
                            torch.arange(cam.hsize, device=dev),
                            indexing="ij")
    ro, rd = rays_for_pixels(cam, xs.reshape(-1), ys.reshape(-1))
    return trace(scene, ro, rd, settings).reshape(r1 - r0, cam.hsize, 3)
