"""The Whitted integrator: camera rays through the whole-tree kernel,
the torch fast node or the sorted torch node.

rray_tpu's render() picks a node per scene: XLA for point-light scenes
with only analytic prims and cheap patterns, and for reflective mesh
scenes (TPU speed choices), the fused Pallas kernel for the rest that
kernels/whitted.py::applicable accepts, XLA scans otherwise. The port
runs every scene that the whitted kernel accepts through the kernel;
both of rray_tpu's routes compute the same image. Scenes the kernel
rejects go to one of two torch nodes. Opaque scenes without CSG take
the fast node, rray_tpu's `_color_at_soa_xla` (tori, Perlin noise and
textures included). Scenes with CSG or transparency take the sorted
node, rray_tpu's `_color_at_sorted_soa`: the CSG filter over sorted (or,
for analytic operands, pairwise-ordered) slots, the n1/n2 containers
walk, and a wavefront of reflection and refraction rays, compacted per
pixel to wavefront_capacity paths. On both nodes the triangle tests
run in the triangle and BVH kernels (a mesh inside a CSG takes its
slots from torch folds instead, as in rray_tpu) and the area-light
shadows of scenes without a mesh, a torus or a CSG in the area-shadow
kernel (kernels/analytic.py).

Area lights draw their jitter from rray_tpu's key chain: level l of the
Whitted chain and light li use seed_table(seed)[l, li] (ops/jitter.py),
the seed that rray_tpu derives from fold_in(fold_in(root, l), 1000 + li)
on both of its routes; the root is PRNGKey(seed) for a frame, and
fold_in(PRNGKey(seed), row_start) for a band of a progressive frame
(render/progressive.py).

Gradients: the torch nodes are differentiable torch ops (each level
checkpointed under settings.remat); the closest-triangle kernels sit
under ops/soa.py ClosestTriangle, and the shadow tests take detached
inputs. On the kernel route WhittedKernel recomputes the torch node in
its backward pass, as rray_tpu's custom VJP recomputes its XLA node.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderSettings, offset_eps
from ..kernels import analytic, whitted
from ..ops import hits, jitter, normals, prng, soa
from ..ops.vec import V3, div
from ..scene import data as sd
from ..scene.data import SceneData
from ..utils import profiling
from . import patterns, shade_soa
from .camera import CameraData, all_rays, rows_rays_soa


def route(scene, settings: RenderSettings = None) -> str:
    """"kernel" (the whitted kernel), "sorted" (the sorted torch node:
    CSG or transparency the kernel rejects) or "fast" (the torch fast
    node: the other scenes the kernel rejects). Under a settings.wavefront
    other than "compact" ("scan", "unrolled") every scene with CSG or
    transparency takes the sorted node: rray_tpu's dispatcher
    (_color_at_sorted_soa) tries its kernel on "compact" alone."""
    sorted_scene = bool(scene.csg_ops) or scene.has_transparent
    if (sorted_scene and settings is not None
            and settings.wavefront != "compact"):
        return "sorted"
    if whitted.applicable(scene):
        return "kernel"
    if sorted_scene:
        return "sorted"
    return "fast"


# ---------------------------------------------------------------------------
# Shading shared by the torch nodes (rray_tpu integrator.py:49-295).
# ---------------------------------------------------------------------------

def _shadow_test_soa(scene, over: V3, direction: V3, dist, settings):
    """Any hit in [0, dist), with the CSG filter applied (rray_tpu
    integrator.py:49-54)."""
    if scene.csg_ops:
        if soa.csg_members_analytic(scene):
            return soa.any_hit_hybrid(scene, over, direction, dist, settings)
        return soa.any_hit_sorted_soa(scene, over, direction, dist, settings)
    return soa.any_hit_soa(scene, over, direction, dist, settings)


def _shadow_fraction_soa(scene, light, over: V3, settings, seed: int):
    """Point: binary shadow (scene.rs:234-245) as 0/1. Area: the share of
    level^2 jittered-grid samples (scene.rs:181-214, light.rs:47-65)
    that are blocked, count / n, drawn from the point-keyed hash with
    `seed` (rray_tpu integrator.py:57-148)."""
    dtype = over.x.dtype
    # A 0/1 outcome (or a count of them): zero gradient almost
    # everywhere, so it takes its inputs detached (rray_tpu stops the
    # gradient of the area lights' inputs).
    over = V3(over.x.detach(), over.y.detach(), over.z.detach())
    if light.kind == "point":
        position = light.position.detach()
        to_light = V3(position[0] - over.x, position[1] - over.y,
                      position[2] - over.z)
        dist = to_light.norm()
        direction = to_light * (1.0 / torch.clamp_min(dist, 1e-30))
        shadowed = _shadow_test_soa(scene, over, direction, dist, settings)
        return shadowed.to(dtype)

    level = light.level
    n = level * level
    kinds = scene.prim_kinds
    if (not scene.counts[6] and not scene.csg_ops and kinds
            and all(k in analytic.OCCLUSION_KINDS for k in kinds)):
        # The whole sample loop in one kernel (B5), which takes no tori
        # and no CSG (nor does rray_tpu's); those take the loop below.
        params, kinds, bounds = analytic.scene_occluders(scene)
        return analytic.area_shadow_fraction(
            (over.x, over.y, over.z), seed,
            torch.cat([light.corner, light.uvec, light.vvec]).detach(),
            params, kinds, level, bounds=bounds)
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
        shadowed = _shadow_test_soa(scene, over_g, direction, dist, settings)
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


def _shade(scene: SceneData, hit: soa.Hit, ro: V3, rd: V3,
           settings: RenderSettings, seeds):
    """The surface at a hit -> (point, eye vector, eye-facing normal,
    over point, class reader, every light's Phong sum masked by found).
    `seeds` holds this level's jitter seed per light."""
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
    return point, eyev, normalv, over, reader, surface


def _level(scene, settings, body, *args):
    """body(*args), one level of a Whitted chain: under autograd with
    settings.remat, through torch.utils.checkpoint, which keeps the
    level's inputs and recomputes the rest in the backward pass
    (rray_tpu's jax.checkpoint on its level bodies); the values are the
    same either way."""
    if (settings.remat and torch.is_grad_enabled()
            and (scene.requires_grad() or any(
                a.requires_grad for a in args if torch.is_tensor(a)))):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return body(*args)


# ---------------------------------------------------------------------------
# The torch fast node (rray_tpu _color_at_soa_xla).
# ---------------------------------------------------------------------------

def _fast_node_eval(scene: SceneData, ro: V3, rd: V3,
                    settings: RenderSettings, seeds):
    """One fast-path node: closest hit and full surface shade ->
    (surface masked by found, over point, reflect direction, reflect
    weight masked by found). `seeds` holds this level's jitter seed per
    light."""
    hit = soa.closest_hit_soa(scene, ro, rd, settings)
    _, _, normalv, over, reader, surface = _shade(scene, hit, ro, rd,
                                                  settings, seeds)
    refl = torch.where(hit.found, reader.col(sd.CLS_REFLECTIVE), 0.0)
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
        surface, over, reflectv, refl = _level(
            scene, settings, lambda ro, rd, s=seeds[level]: _fast_node_eval(
                scene, ro, rd, settings, s), ro, rd)
        acc = acc + surface * weights
        ro, rd, weights = over, reflectv, weights * refl
    return acc


# ---------------------------------------------------------------------------
# The sorted torch node (rray_tpu integrator.py:298-690, 1070-1160).
# ---------------------------------------------------------------------------

def _schlick_soa(eyev: V3, normalv: V3, n1, n2):
    """Fresnel reflectance, Schlick's approximation (computations.rs:
    39-54); 1 under total internal reflection."""
    cos = eyev.dot(normalv)
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-30))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_eff) ** 5
    tir = (n1 > n2) & (sin2_t > 1.0)
    return torch.where(tir, 1.0, reflectance)


def _sorted_hit(scene: SceneData, ro: V3, rd: V3, settings):
    """The node's hit -> (Hit, sorted slots or None, the hit's slot
    index or None, filtered operand slots or None). A CSG over analytic
    operands sorts nothing: the operands' slots are filtered pairwise
    and merged with the closest hit over the rest (meshes through the
    kernels). A mesh inside a CSG takes the full sorted slot list.
    Transparency without CSG takes the closest hit alone."""
    if scene.csg_ops and soa.csg_members_analytic(scene):
        hit, member_slots = soa.closest_hit_hybrid(scene, ro, rd, settings)
        return hit, None, None, member_slots
    if scene.csg_ops:
        if scene.counts[6]:
            slots = soa.sorted_slots_full_soa(scene, ro, rd, settings)
        else:
            slots = soa.sorted_slots_soa(scene, ro, rd)
        slots = soa.apply_csg_soa(scene, slots)
        found, t, prim, hit_idx, *uvt = soa.select_hit_slots(slots)
        hit = soa.Hit(found=found, t=t, prim=prim, cls=None)
        if uvt:
            hit.u, hit.v, hit.tri = uvt
        return hit, slots, hit_idx, None
    return soa.closest_hit_soa(scene, ro, rd, settings), None, None, None


def _sorted_node_eval(scene: SceneData, ro: V3, rd: V3,
                      settings: RenderSettings, seeds):
    """One sorted-path Whitted node -> (surface, over, under, reflect
    direction, refract direction, reflect weight, refract weight). The
    weights carry reflective and transparency with the Schlick blend
    applied where both are nonzero (scene.rs:159-178), so the ray tree
    is a weighted sum over its paths. `seeds` holds this level's jitter
    seed per light."""
    hit, slots, hit_idx, member_slots = _sorted_hit(scene, ro, rd, settings)
    found = hit.found
    point, eyev, normalv, over, reader, surface = _shade(
        scene, hit, ro, rd, settings, seeds)
    under = point - normalv * offset_eps(ro.x.dtype)

    if scene.has_transparent and slots is not None:
        n1, n2 = soa.refractive_indices_soa(scene, slots, hit_idx,
                                            settings.containers_depth)
    elif scene.has_transparent:
        n1, n2 = soa.refractive_indices_direct(
            scene, ro, rd, torch.where(found, hit.t, -1.0), hit.prim,
            settings, member_slots=member_slots)
    else:
        n1 = n2 = torch.ones_like(hit.t)

    reflective = torch.where(found, reader.col(sd.CLS_REFLECTIVE), 0.0)
    transparency = torch.where(found, reader.col(sd.CLS_TRANSPARENCY), 0.0)
    reflectv = rd.reflect(normalv)
    # Refraction direction and total internal reflection
    # (scene.rs:310-336).
    n_ratio = n1 / n2
    cos_i = eyev.dot(normalv)
    sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-30))
    direction = normalv * (n_ratio * cos_i - cos_t) - eyev * n_ratio
    live = found & ~tir & (transparency > 0.0)
    refr_dir = V3(torch.where(live, direction.x, 0.0),
                  torch.where(live, direction.y, 0.0),
                  torch.where(live, direction.z, 1.0))
    refl_w = reflective
    refr_w = torch.where(live, transparency, 0.0)
    if scene.has_reflective and scene.has_transparent:
        both = (reflective > 0.0) & (transparency > 0.0)
        reflectance = _schlick_soa(eyev, normalv, n1, n2)
        refl_w = torch.where(both, reflective * reflectance, refl_w)
        refr_w = torch.where(both, refr_w * (1.0 - reflectance), refr_w)
    return surface, over, under, reflectv, refr_dir, refl_w, refr_w


def _color_at_sorted_scan(scene: SceneData, ro: V3, rd: V3, remaining: int,
                          settings: RenderSettings, seeds) -> V3:
    """The exhaustive level-synchronous wavefront: W = 2^remaining rows
    per pixel when both reflection and refraction spawn (else 1), heap
    order (parent row i -> rows 2i, 2i + 1), zero weights on dead rows.
    Level l draws its jitter with seeds[l]. At depth 0 only level 0 runs
    (rray_tpu's scan fails there when both spawn: W // 2 = 0)."""
    seeds = seeds.tolist()
    spawn_refl, spawn_refr = scene.has_reflective, scene.has_transparent
    if remaining == 0 or not (spawn_refl or spawn_refr):
        return _sorted_node_eval(scene, ro, rd, settings, seeds[0])[0]
    both = spawn_refl and spawn_refr
    W = 2 ** remaining if both else 1
    R = ro.x.shape[0]

    def expand(c, fill):
        return torch.cat([c, c.new_full(((W - 1) * R,), fill)])

    ro = V3(expand(ro.x, 0.0), expand(ro.y, 0.0), expand(ro.z, 0.0))
    rd = V3(expand(rd.x, 0.0), expand(rd.y, 0.0), expand(rd.z, 1.0))
    weights = expand(torch.ones_like(ro.x[:R]), 0.0)
    zero = torch.zeros_like(ro.x[:R])
    acc = V3(zero, zero, zero)

    def interleave(a, b):
        # The children of the first W // 2 parent rows, in heap order.
        return torch.stack([a.reshape(W, R)[:W // 2],
                            b.reshape(W, R)[:W // 2]], dim=1).reshape(W * R)

    for level in range(remaining + 1):
        if not bool((weights != 0.0).any()):
            break  # every path is dead: the remaining levels add zeros
        surface, over, under, reflectv, refr_dir, refl_w, refr_w = _level(
            scene, settings, lambda ro, rd, s=seeds[level]: _sorted_node_eval(
                scene, ro, rd, settings, s), ro, rd)
        contrib = surface * weights
        acc = acc + V3(contrib.x.reshape(W, R).sum(0),
                       contrib.y.reshape(W, R).sum(0),
                       contrib.z.reshape(W, R).sum(0))
        if both:
            ro = V3(*(interleave(a, b) for a, b in zip(
                (over.x, over.y, over.z), (under.x, under.y, under.z))))
            rd = V3(*(interleave(a, b) for a, b in zip(
                (reflectv.x, reflectv.y, reflectv.z),
                (refr_dir.x, refr_dir.y, refr_dir.z))))
            weights = interleave(weights * refl_w, weights * refr_w)
        elif spawn_refl:
            ro, rd, weights = over, reflectv, weights * refl_w
        else:
            ro, rd, weights = under, refr_dir, weights * refr_w
    return acc


def _compact_topw(W: int, cw, ops):
    """The W rows of largest weight per pixel: a stable sort of -cw
    along the path axis ([2W, R]; ties keep row order, and -0.0 ranks
    with +0.0, as lax.sort has them), then each operand gathered."""
    keys = torch.where(cw == 0.0, 0.0, -cw)
    order = torch.sort(keys, dim=0, stable=True).indices[:W]
    return tuple(torch.gather(a, 0, order) for a in ops)


def _color_at_compact_scan(scene: SceneData, ro: V3, rd: V3, remaining: int,
                           settings: RenderSettings, seeds) -> V3:
    """The wavefront with per-pixel live-path compaction, for scenes
    where both reflection and refraction spawn: [W, R] paths with W =
    min(max(wavefront_capacity, 2), 2^remaining); after each level the
    2W children (reflect rows, then refract rows) keep the W of largest
    weight. Zero weights sort last, so a pixel loses a live path only
    when it holds more than W of them. Levels 0 and 1 (while their 2^l
    paths fit) run at their own width with the children placed in heap
    order, without a sort. A level whose weights are all zero ends the
    walk. Level l draws its jitter with seeds[l]."""
    seeds = seeds.tolist()
    R = ro.x.shape[0]
    W = min(max(int(settings.wavefront_capacity), 2), 2 ** remaining)
    zero = torch.zeros_like(ro.x)
    acc = (zero, zero, zero)
    state = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, torch.ones_like(ro.x))

    def level_eval(state, width, level):
        """One level over [width, R] paths -> (acc, the children as
        (reflect, refract) pairs of ox oy oz dx dy dz weight)."""
        def body(*state):
            wf = state[6]
            surface, over, under, reflectv, refr_dir, refl_w, refr_w = \
                _sorted_node_eval(scene, V3(*state[:3]), V3(*state[3:6]),
                                  settings, seeds[level])
            return tuple((c * wf).reshape(width, R).sum(0)
                         for c in (surface.x, surface.y, surface.z)), (
                (over.x, under.x), (over.y, under.y), (over.z, under.z),
                (reflectv.x, refr_dir.x), (reflectv.y, refr_dir.y),
                (reflectv.z, refr_dir.z), (wf * refl_w, wf * refr_w))

        contrib, children = _level(scene, settings, body, *state)
        return tuple(a + c for a, c in zip(acc, contrib)), children

    width, level = 1, 0
    while level <= remaining and 2 * width <= W and level < 2:
        if level > 0 and not bool((state[6] != 0.0).any()):
            return V3(*acc)
        acc, children = level_eval(state, width, level)
        state = tuple(torch.cat(pair) for pair in children)
        width, level = 2 * width, level + 1
    # Lift to W rows: zero-weight rows, direction +z, below.
    state = tuple(torch.cat([a, a.new_full(((W - width) * R,),
                                           1.0 if i == 5 else 0.0)])
                  for i, a in enumerate(state))
    for level in range(level, remaining + 1):
        if not bool((state[6] != 0.0).any()):
            break
        acc, children = level_eval(state, W, level)
        two = [torch.cat([a.reshape(W, R), b.reshape(W, R)])
               for a, b in children]
        state = tuple(a.reshape(W * R)
                      for a in _compact_topw(W, two[6], two))
    return V3(*acc)


def _color_at_sorted_unrolled(scene: SceneData, ro: V3, rd: V3,
                              remaining: int, settings: RenderSettings,
                              seeds) -> V3:
    """The level-synchronous wavefront over the exact Whitted ray tree
    (rray_tpu _color_at_sorted_unrolled): level l is one node evaluation
    over the previous level's children, concatenated (reflect rays, then
    refract rays, when both spawn: 2^l R rays), with per-ray path
    weights; no path is dropped. A level whose weights are all zero
    ends the walk (its levels would add zeros). Level l draws its
    jitter with seeds[l]."""
    seeds = seeds.tolist()
    R = ro.x.shape[0]
    zero = torch.zeros_like(ro.x)
    acc = V3(zero, zero, zero)
    spawn_refl, spawn_refr = scene.has_reflective, scene.has_transparent
    weights = torch.ones_like(ro.x)
    for level in range(remaining + 1):
        if level and not bool((weights != 0.0).any()):
            break
        surface, over, under, reflectv, refr_dir, refl_w, refr_w = _level(
            scene, settings, lambda ro, rd, s=seeds[level]: _sorted_node_eval(
                scene, ro, rd, settings, s), ro, rd)
        contrib = surface * weights
        width = contrib.x.shape[0] // R
        acc = acc + V3(*(c.reshape(width, R).sum(0)
                         for c in (contrib.x, contrib.y, contrib.z)))
        if level == remaining:
            break
        if spawn_refl and spawn_refr:
            ro = V3(*(torch.cat(p) for p in zip(
                (over.x, over.y, over.z), (under.x, under.y, under.z))))
            rd = V3(*(torch.cat(p) for p in zip(
                (reflectv.x, reflectv.y, reflectv.z),
                (refr_dir.x, refr_dir.y, refr_dir.z))))
            weights = torch.cat([weights * refl_w, weights * refr_w])
        elif spawn_refl:
            ro, rd, weights = over, reflectv, weights * refl_w
        elif spawn_refr:
            ro, rd, weights = under, refr_dir, weights * refr_w
        else:
            break
    return acc


WAVEFRONTS = ("compact", "scan", "unrolled")


def color_at_sorted(scene: SceneData, ro: V3, rd: V3, remaining: int,
                    settings: RenderSettings, seeds) -> V3:
    """The sorted node's wavefront (rray_tpu _color_at_sorted_soa
    without its kernel branch, which route() takes first): "unrolled"
    when asked for; else "compact" where both reflection and refraction
    spawn below depth 0, and the exhaustive scan otherwise, whose width
    there is 1. seeds: the [remaining + 1, L] table of ops/jitter.py
    seed_table."""
    if settings.wavefront not in WAVEFRONTS:
        raise ValueError(f"wavefront {settings.wavefront!r}: one of "
                         f"{', '.join(map(repr, WAVEFRONTS))}")
    if settings.wavefront == "unrolled":
        return _color_at_sorted_unrolled(scene, ro, rd, remaining, settings,
                                         seeds)
    if (settings.wavefront == "compact" and remaining > 0
            and scene.has_reflective and scene.has_transparent):
        return _color_at_compact_scan(scene, ro, rd, remaining, settings,
                                      seeds)
    return _color_at_sorted_scan(scene, ro, rd, remaining, settings, seeds)


def _tile_rays(scene: SceneData, hsize: int, settings: RenderSettings) -> int:
    """Rays per batch of the sorted node (rray_tpu integrator.py:
    1110-1157): settings.rows_per_tile raster rows, fewer where the
    wavefront's [K, W * R] slot buffers, a mesh's [R, tri_chunk] torch
    folds (times the area samples per step) or a texture's [R, 128]
    fetch would pass settings.max_rc_elems elements. rray_tpu bounds the
    mesh folds where they are XLA code: with a mesh inside a CSG, or
    without its kernels; in the port they are torch code wherever they
    run, in a mesh inside a CSG and in a transparent mesh's n1/n2 fold."""
    rows = settings.rows_per_tile

    def cap(per_ray):
        max_rays = max(settings.max_rc_elems // per_ray, 1)
        return min(rows, max(max_rays // hsize, 1))

    if scene.has_transparent and scene.has_reflective:
        # "scan" and "unrolled" widen to 2^depth rays per pixel.
        if settings.wavefront == "compact":
            W = min(max(int(settings.wavefront_capacity), 2),
                    2 ** settings.depth)
            rows = cap(W * (settings.max_hits if scene.csg_ops else 8))
        else:
            rows = cap(8 * 2 ** settings.depth)
    T = scene.counts[6]
    mesh_in_csg = bool(scene.csg_ops) and not soa.csg_members_analytic(scene)
    if T and (mesh_in_csg or scene.has_transparent):
        g = max([light.level for light in scene.lights
                 if light.kind == "area"] or [1])
        rows = cap(min(settings.tri_chunk, T) * g)
    if any(shade_soa._has_image(p) for p in scene.patterns):
        rows = cap(128)
    return max(rows * hsize, 1)


def sorted_frame(scene: SceneData, ro: V3, rd: V3, hsize: int,
                 settings: RenderSettings, seeds) -> V3:
    """The sorted node over a raster's rays (raster order, `hsize` per
    row) in batches of _tile_rays rays. A pixel's value does not depend
    on its batch: the compaction is per pixel, the jitter point-keyed."""
    tile = _tile_rays(scene, hsize, settings)
    parts = []
    for i in range(0, ro.x.shape[0], tile):
        part = lambda v: V3(v.x[i:i + tile], v.y[i:i + tile], v.z[i:i + tile])
        out = color_at_sorted(scene, part(ro), part(rd), settings.depth,
                              settings, seeds)
        parts.append((out.x, out.y, out.z))
    return V3(*(torch.cat(c) for c in zip(*parts)))


def reference_node(scene: SceneData, ro: V3, rd: V3, remaining: int,
                   settings: RenderSettings, seeds) -> V3:
    """The kernel-free torch Whitted evaluation of a scene (rray_tpu
    _xla_reference_node): the sorted node for CSG or transparency, else
    the fast node. The whitted kernel's backward recomputes through it,
    so the kernel route's gradients are the torch route's."""
    if scene.csg_ops or scene.has_transparent:
        return color_at_sorted(scene, ro, rd, remaining, settings, seeds)
    return color_at_fast(scene, ro, rd, remaining, settings, seeds)


def _kernel_frame(scene, settings, seed, width, rays):
    """whitted_compact over the six ray components; the raster width
    lets the kernel shade the rays in pixel tiles (None: row order)."""
    return whitted.whitted_compact(
        rays[:3], rays[3:], **whitted.kernel_inputs(scene, settings, seed),
        width=width)


class WhittedKernel(torch.autograd.Function):
    """The whitted kernel under autograd (rray_tpu _whitted_kernel_call
    and its custom VJP). Inputs: the six ray components, then the
    scene's float leaves in `scene.data.float_leaves` order; `frame`
    (the scene whose leaves these are, the settings, the seed and the
    raster width) travels beside them. Forward: whitted_compact as
    render() calls it, the CUDA kernel on the card and its plain version
    on the CPU. Backward: the scene rebuilt from detached leaves,
    reference_node recomputed with the same seed table, and
    torch.autograd.grad into the leaves and rays, in batches of
    `_tile_rays` rays, so that memory stays bounded on a large frame
    (rays without a raster width in one batch, as rray_tpu's color_at
    has them)."""

    @staticmethod
    def forward(ctx, frame, *tensors):
        ctx.frame = frame
        ctx.save_for_backward(*tensors)
        return _kernel_frame(*frame, tensors[:6])

    @staticmethod
    def backward(ctx, *cts):
        scene, settings, seed, width = ctx.frame
        tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        keys = [k for k, _ in sd.float_leaves(scene)]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(tensors[6:], needs[6:])]
        scene = sd.replace_leaves(scene, dict(zip(keys, leaves)))
        seeds = jitter.seed_table(seed, settings.depth, len(scene.lights))
        grads = [None if not n else torch.zeros_like(t)
                 for t, n in zip(tensors, needs)]
        R = tensors[0].shape[0]
        tile = _tile_rays(scene, width, settings) if width else max(R, 1)
        for i in range(0, R, tile):
            rays = [t[i:i + tile].detach().requires_grad_(n)
                    for t, n in zip(tensors[:6], needs[:6])]
            wanted = [(j, t) for j, t in enumerate(rays + leaves)
                      if t.requires_grad]
            with torch.enable_grad():
                out = reference_node(scene, V3(*rays[:3]), V3(*rays[3:]),
                                     settings.depth, settings, seeds)
                pairs = [(o, c[i:i + tile]) for o, c in zip(
                    (out.x, out.y, out.z), cts) if o.requires_grad]
                if not pairs or not wanted:
                    continue
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [t for _, t in wanted],
                    [c for _, c in pairs], allow_unused=True)
            for (j, _), g in zip(wanted, got):
                if g is None:
                    continue
                if j < 6:
                    grads[j][i:i + tile] = g
                else:
                    grads[j] += g
        return (None, *grads)


def trace_rays(scene: SceneData, ro: V3, rd: V3, settings: RenderSettings,
               seed=0, width=None):
    """The Whitted tree of a canonical scene along rays -> (r, g, b) [R]
    tensors, through the scene's route at depth settings.depth. `seed`,
    an int or a root key (ops/prng.py), keys the area lights' jitter.
    `width` is the raster width of camera rays in row-major order (the
    whitted kernel's pixel tiles, the sorted node's batches of raster
    rows); without it the rays are one batch, as in rray_tpu's
    color_at. Autograd reaches the scene's float leaves on every route:
    through the torch nodes, and through WhittedKernel on the kernel
    route when some leaf or ray requires grad."""
    node = route(scene, settings)
    if node == "kernel":
        rays = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)
        frame = (scene, settings, seed, width)
        if torch.is_grad_enabled() and (
                scene.requires_grad() or any(c.requires_grad for c in rays)):
            return WhittedKernel.apply(frame, *rays, *(
                t for _, t in sd.float_leaves(scene)))
        return _kernel_frame(*frame, rays)
    seeds = jitter.seed_table(seed, settings.depth, len(scene.lights))
    if node == "fast":
        out = color_at_fast(scene, ro, rd, settings.depth, settings, seeds)
    elif width:
        out = sorted_frame(scene, ro, rd, width, settings, seeds)
    else:
        out = color_at_sorted(scene, ro, rd, settings.depth, settings, seeds)
    return out.x, out.y, out.z


def color_at(scene: SceneData, ro, rd, remaining: int,
             settings: RenderSettings, key):
    """Colour seen along rays, [R, 3] origins and directions -> [R, 3]
    (rray_tpu's public color_at): the scene canonicalized, then its
    route at depth `remaining`, keyed by `key` (an int seed or a root
    key), the rays in one batch."""
    scene = sd.canonicalize(scene)
    settings = dataclasses.replace(settings, depth=remaining)
    rgb = trace_rays(scene, V3(ro[:, 0], ro[:, 1], ro[:, 2]),
                     V3(rd[:, 0], rd[:, 1], rd[:, 2]), settings, key)
    return torch.stack(rgb, dim=-1)


def render_block(scene: SceneData, cam: CameraData, r0: int, r1: int,
                 settings: RenderSettings = RenderSettings(), seed=0):
    """Raster rows [r0, r1) of a frame -> [r1 - r0, hsize, 3] on the
    scene's device: the scene canonicalized (scene.data.canonicalize),
    then the rows' camera rays traced (`trace_rays`) with the raster
    width, keyed by `seed` (an int or a root key)."""
    if r1 <= r0:  # an empty block: a rank past the last row
        return cam.inv.new_zeros((0, cam.hsize, 3))
    with profiling.span("render"):
        ro, rd = rows_rays_soa(cam, r0, r1)
        rgb = trace_rays(sd.canonicalize(scene), ro, rd, settings, seed,
                         cam.hsize)
        return torch.stack(rgb, dim=-1).reshape(r1 - r0, cam.hsize, 3)


def render(scene: SceneData, cam: CameraData,
           settings: RenderSettings = RenderSettings(), seed: int = 0):
    """Full-frame render -> image [vsize, hsize, 3] (linear, unclamped),
    on the scene's device. `seed` keys the area lights' jitter, as
    rray_tpu's render(seed=...) does (`render_block` over every row)."""
    return render_block(scene, cam, 0, cam.vsize, settings, seed)


# ---------------------------------------------------------------------------
# The per-ray (AoS) reference node (rray_tpu integrator.py:742-891).
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _reflect(v, n):
    return v - n * (2.0 * _dot(v, n))[:, None]


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-30)


def _schlick(eyev, normalv, n1, n2):
    """Fresnel reflectance, Schlick's approximation (computations.rs:
    39-54); 1 under total internal reflection."""
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
    """Phong (light.rs:98-140) on [R, 3] vectors; `shadow_frac` in [0, 1]."""
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


def _shadow_fraction(scene, light, over, settings, seed: int):
    """Point lights: 0/1; area lights: the blocked share of level^2
    jittered-grid samples, drawn from the point-keyed hash with `seed`
    (ops/jitter.py, the draws of the torch nodes and the kernels)."""
    R = over.shape[0]
    dtype = over.dtype
    if light.kind == "point":
        v = light.position[None, :] - over
        dist = torch.linalg.norm(v, dim=-1)
        direction = v / torch.clamp_min(dist[:, None], 1e-30)
        return hits.shadow_hit(scene, over, direction, dist,
                               settings).to(dtype)
    level = light.level
    n = level * level
    held = over.detach()
    rand = jitter.point_jitter(seed, held[:, 0], held[:, 1], held[:, 2], n,
                               dtype=dtype).permute(1, 2, 0)  # [n, R, 2]
    k = torch.arange(n, device=over.device)
    ur = div((k % level).to(dtype)[:, None] + rand[:, :, 0], level)
    vr = div((k // level).to(dtype)[:, None] + rand[:, :, 1], level)
    pos = (light.corner[None, None, :]
           + light.uvec[None, None, :] * ur[:, :, None]
           + light.vvec[None, None, :] * vr[:, :, None])  # [n, R, 3]
    over_t = over[None].expand(pos.shape).reshape(n * R, 3)
    v = pos.reshape(n * R, 3) - over_t
    dist = torch.linalg.norm(v, dim=-1)
    direction = v / torch.clamp_min(dist[:, None], 1e-30)
    shadowed = hits.shadow_hit(scene, over_t, direction, dist, settings)
    return torch.mean(shadowed.reshape(n, R).to(dtype), dim=0)


def color_at_aos(scene: SceneData, ro, rd, remaining: int,
                 settings: RenderSettings, seed=0):
    """The per-ray Whitted node over [R, 3] rays -> [R, 3] colours
    (rray_tpu/render/integrator.py::_color_at_sorted): the sorted hit
    prefix (ops/hits.py), normals (ops/normals.py), patterns
    (render/patterns.py), Phong with shadows, and the exact recursion
    tree of reflection and refraction (Schlick-blended where both
    spawn), 2^(remaining + 1) - 1 node evaluations over all R rays.

    This is rray_tpu's A/B oracle, written apart from the routed nodes:
    plain torch ops on the rays' device, none of the port's CUDA
    kernels. `seed` (an int or a root key, ops/prng.py) keys the area
    jitter by rray_tpu's per-node chain: light li draws from
    fold_in(key, 1000 + li), the reflected child takes fold_in(key, 1),
    the refracted child fold_in(key, 2). That chain is not the routed
    nodes' per-level seed_table, so area-light frames draw other jitter
    than render()'s."""
    key = prng.root_key(seed)
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
    del slots  # the children run while this node's locals stay alive

    base_color = patterns.pattern_at_object(scene, prim, over)
    surface = torch.zeros_like(ro)
    for li, light in enumerate(scene.lights):
        frac = _shadow_fraction(
            scene, light, over, settings,
            jitter.seed_from_key(prng.fold_in(key, 1000 + li)))
        surface = surface + _lighting(scene, prim, base_color, light, over,
                                      eyev, normalv, frac)

    reflective = scene.mat_reflective[prim]
    transparency = scene.mat_transparency[prim]
    reflected = torch.zeros_like(ro)
    refracted = torch.zeros_like(ro)

    if remaining > 0 and scene.has_reflective:
        rc = color_at_aos(scene, over, reflectv, remaining - 1, settings,
                          prng.fold_in(key, 1))
        reflected = rc * reflective[:, None]

    if remaining > 0 and scene.has_transparent:
        n_ratio = n1 / n2
        cos_i = _dot(eyev, normalv)
        sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        tir = sin2_t > 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-30))
        direction = (normalv * (n_ratio * cos_i - cos_t)[:, None]
                     - eyev * n_ratio[:, None])
        live = found & ~tir & (transparency > 0.0)
        safe_dir = torch.where(live[:, None], direction,
                               torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                            device=ro.device))
        rc = color_at_aos(scene, under, safe_dir, remaining - 1, settings,
                          prng.fold_in(key, 2))
        refracted = torch.where(live[:, None], rc * transparency[:, None],
                                0.0)

    if scene.has_reflective and scene.has_transparent:
        both = (reflective > 0.0) & (transparency > 0.0)
        reflectance = _schlick(eyev, normalv, n1, n2)
        blended = (reflected * reflectance[:, None]
                   + refracted * (1.0 - reflectance)[:, None])
        secondary = torch.where(both[:, None], blended, reflected + refracted)
    else:
        secondary = reflected + refracted
    return torch.where(found[:, None], surface + secondary, 0.0)


def render_aos(scene: SceneData, cam: CameraData,
               settings: RenderSettings = RenderSettings(), seed=0):
    """A full frame through color_at_aos -> image [vsize, hsize, 3] on
    the scene's device: the camera's [R, 3] rays (camera.all_rays) in
    batches of raster rows by the sorted node's rule for the exhaustive
    wavefront (_tile_rays under "scan"), each batch keyed by `seed`."""
    scene = sd.canonicalize(scene)
    ro, rd = all_rays(cam)
    tile = _tile_rays(scene, cam.hsize,
                      dataclasses.replace(settings, wavefront="scan"))
    out = [color_at_aos(scene, ro[i:i + tile], rd[i:i + tile],
                        settings.depth, settings, seed)
           for i in range(0, ro.shape[0], tile)]
    return torch.cat(out).reshape(cam.vsize, cam.hsize, 3)

