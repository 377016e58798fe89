"""The whole compact Whitted wavefront per primary ray: CUDA kernel,
plain PyTorch version, and the wrapper that picks between them.

This is the port of rray_tpu's Pallas kernel
`rray_tpu/kernels/whitted.py::whitted_compact` (body `_kernel`, node
`_node_row`), all five stages: a (core: analytic prims, point lights,
cheap patterns, depth 0 and the width-1 reflection/refraction chain), b
(compact wavefront: W path rows per pixel, 2W children, stable top-W by
weight), c (area lights: level^2 jittered shadow samples per light,
drawn from the point-keyed hash of ops/jitter.py with one seed per level
and light), d (the in-kernel mesh: up to 1024 triangles folded after
the analytic prims, for closest hits and shadows, with materials and
patterns per material group) and e (tori through the quartic, CSG over
analytic operands through the pairwise-parity filter `soa.csg_keeps` on
closest hits and shadow segments, Perlin noise and perturbed patterns,
and image textures read inside the kernel). The CUDA source is
kernels/csrc/whitted.cu: one thread runs one primary ray's whole tree
with its path state in registers, the scene tables (the mesh included,
packed by `kernel_tables`) staged once per block in shared memory, the
texel table read from global memory; blocks shade 16x8 pixel tiles of
the raster when the caller passes its width. Stage e is a compile-time
switch of the kernel (`ext`), so scenes without it run kernels without
its code.

Textures: rray_tpu's kernel emits a multiplier and a flat texel index
and completes the image outside the kernel (a Mosaic workaround for
gathers). Here the kernel reads the texel itself and evaluates the
pattern tree with it in place, as rray_tpu's XLA path does; the plain
version follows the kernel. The two forms agree up to rounding.

`whitted_compact` takes the tensors' device as the switch: CPU tensors
run `whitted_compact_reference` (the plain version), CUDA tensors launch
the kernel or raise. Both compute the same function; the plain version
is dtype-generic so the tests can run it in float64 against rray_tpu's
XLA path, while the kernel is float32 only, as the TPU kernel is.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import EPSILON, hit_match_tol, offset_eps
from ..ops import jitter, noise, quartic, soa
from ..ops.vec import V3, div
from ..render import shade_soa
from ..scene import data as sd
from ..utils import profiling
from . import triangles
from .analytic import OCCLUSION_KINDS, _occludes, area_sample

CHEAP_PATTERNS = ("solid", "stripe", "gradient", "ring", "checker", "blend")
# The pattern nodes the kernel evaluates (rray_tpu whitted.py:64): the
# cheap ones, Perlin noise and perturbation, and image leaves.
KERNEL_PATTERNS = CHEAP_PATTERNS + ("noise", "perturbed", "image")
# Pattern node codes shared with csrc/whitted_device.cuh (PType), then
# the pattern programs' control ops.
PATTERN_CODES = {name: i for i, name in enumerate(KERNEL_PATTERNS)}
OP_JUMP, OP_MID, OP_COMBINE, OP_POPSCALE, OP_END = 9, 10, 11, 12, 13
# Path-row capacities the CUDA kernel is instantiated for.
WIDTHS = (1, 2, 4, 8, 16, 32)
MAX_PRIMS = 16
# Table bounds of csrc/whitted.cu. The scene tables and the pattern
# stacks live in dynamic shared memory up to Hopper's opt-in limit of 227
# KB per block, less the kernel's static 16 bytes (its mbarrier); a
# pattern tree is at most this deep, so a thread's stack holds at most
# MAX_PATTERN_DEPTH - 1 frames.
MAX_PATTERN_ROWS = 256
MAX_LIGHTS = 64
MAX_PATTERN_DEPTH = 8
SMEM_BYTES = 227 * 1024 - 16
# Threads per block (a 16x8 pixel tile) and the words of a pattern-stack
# frame (csrc/whitted.cu kThreads, whitted_device.cuh FRAME_WORDS).
THREADS, TILE_W, TILE_H = 128, 16, 8
FRAME_WORDS = 6
# CSG member-slot buckets the stage-e kernel is instantiated for at W = 1
# (csrc/whitted_device.cuh MemberSlots): 8 slots unrolled in registers,
# or the general form for up to 16 prims x 5 slots.
SLOT_BUCKETS = (8, 80)
# Descriptor words of a launch, in csrc/whitted_device.cuh Desc order:
# word offsets of the staged tables, then counts and flags.
DESC_FIELDS = ("prims", "pats", "lights", "kinds", "roots", "prog",
               "levels", "seeds", "pmeta", "member", "csg_ops", "csg_side",
               "tris", "tboxes", "P", "L", "T", "n_chunks", "C", "depth",
               "has_refl", "has_refr", "width", "R", "words")
# The in-kernel mesh (rray_tpu whitted.py:297-307): at most 1024
# triangles, culled in Morton-ordered chunks of 24, at most 8 (shade
# class, pattern) material groups. Triangle rows: p1 e1 e2 (0-8), vertex
# normals n1 n2 n3 (9-17), material group id (18).
MESH_MAX_TRIS = 1024
MESH_CHUNK = 24
MAX_GROUPS = 8
T_COLS = 19
# Texel indices below 2^24 (rray_tpu whitted.py:149); a packed RGB8
# texel rides in the float texel table exactly for the same reason.
MAX_TEXELS = 1 << 24

# Kernel launches made by `whitted_compact` in this process (CPU calls,
# which run the plain version, do not count), and the last launch's
# shape: {"W", "ext", "KB", "smem", "blocks_per_sm"}.
launches = 0
# Scene tables packed by kernel_inputs (once per scene, depth and W).
table_builds = 0
last_launch: dict = {}


def _tree_all(node, names) -> bool:
    if node is None:
        return True
    return node.ptype in names and _tree_all(node.a, names) \
        and _tree_all(node.b, names)


def tree_cheap(node) -> bool:
    """Does this pattern tree hold only cheap pattern nodes?"""
    return _tree_all(node, CHEAP_PATTERNS)


def _tree_depth(node) -> int:
    if node is None:
        return 0
    return 1 + max(_tree_depth(node.a), _tree_depth(node.b))


def _tree_rows(node) -> int:
    if node is None:
        return 0
    return 1 + _tree_rows(node.a) + _tree_rows(node.b)


def _n_images(node) -> int:
    if node is None:
        return 0
    return int(node.ptype == "image") + _n_images(node.a) + _n_images(node.b)


def _image_nodes(node):
    """Image leaves of a tree in pre-order (pack_patterns' row order)."""
    if node is None:
        return []
    return ([node] if node.ptype == "image" else []) + \
        _image_nodes(node.a) + _image_nodes(node.b)


def needs_ext(scene) -> bool:
    """Does the scene need the kernel's stage e (CSG, tori, noise,
    perturbed or image patterns)?"""
    return bool(scene.csg_ops) or sd.TORUS in scene.prim_kinds \
        or not all(tree_cheap(p) for p in scene.patterns)


def csg_unsupported(scene) -> str | None:
    """Why the kernel cannot filter this scene's CSG — or None. It
    filters a CSG over analytic operands in an opaque scene; a mesh
    inside a CSG, or a CSG with transparency, takes the sorted torch node
    (rray_tpu whitted.py:110-115)."""
    if scene.csg_ops and (not soa.csg_members_analytic(scene)
                          or scene.has_transparent):
        return ("CSG with a mesh operand or with transparency (the sorted "
                "torch node renders it)")
    return None


def unsupported(scene) -> str | None:
    """Why the kernel cannot run this scene — or None when it can. The
    gate is rray_tpu's applicable() (whitted.py:92-156) clause by clause,
    then the port's table bounds."""
    reason = csg_unsupported(scene)
    if reason is not None:
        return reason
    kinds = scene.prim_kinds
    T = scene.counts[6]
    if T > MESH_MAX_TRIS:
        return f"meshes of more than {MESH_MAX_TRIS} triangles"
    if T and scene.has_transparent:
        return "transparent scenes with meshes"
    if T and len(_tri_groups(scene)[1]) > MAX_GROUPS:
        return f"meshes of more than {MAX_GROUPS} material groups"
    if not kinds:
        return "scenes without primitives"
    if sum(k != sd.TRIANGLE for k in kinds) > MAX_PRIMS:
        return f"more than {MAX_PRIMS} analytic primitives"
    if not all(_tree_all(p, KERNEL_PATTERNS) for p in scene.patterns):
        return "test patterns"
    if any(_n_images(p) for p in scene.patterns):
        if scene.has_reflective or scene.has_transparent:
            return "textured scenes with reflection or transparency"
        if any(_n_images(p) > 1 for p in scene.patterns):
            return "pattern trees with more than one image"
        if sum(n.texture.shape[0] * n.texture.shape[1]
               for p in scene.patterns for n in _image_nodes(p)) \
                >= MAX_TEXELS:
            return f"{MAX_TEXELS} texels or more"
        if any(k == sd.TRIANGLE and pat < len(scene.patterns)
               and _n_images(scene.patterns[pat])
               for k, pat in zip(kinds, scene.prim_pattern_static)):
            return "textured triangles"
    if len(scene.lights) > MAX_LIGHTS:
        return f"more than {MAX_LIGHTS} lights"
    if any(_tree_depth(p) > MAX_PATTERN_DEPTH for p in scene.patterns) \
            or sum(_tree_rows(p) for p in scene.patterns) > MAX_PATTERN_ROWS:
        return "pattern trees past the kernel's table bounds"
    return None


def applicable(scene) -> bool:
    """Can this scene's Whitted evaluation run as the kernel? Analytic
    prims (tori included; at most 16), CSG over analytic operands without
    transparency, opaque meshes of at most 1024 triangles in at most 8
    material groups, point and area lights, every pattern but `test`, and
    image textures on depth-0 scenes (one image per tree, none on a
    mesh)."""
    return unsupported(scene) is None


def wavefront_shape(scene, settings):
    """(depth, W) as rray_tpu's _whitted_kernel_call derives them: the
    compact wavefront when both reflection and refraction spawn, the
    width-1 chain when one does, a single level when neither does."""
    remaining = settings.depth
    spawns = scene.has_reflective or scene.has_transparent
    both = scene.has_reflective and scene.has_transparent
    depth = remaining if spawns else 0
    W = min(max(int(settings.wavefront_capacity), 2), 2 ** remaining) \
        if (both and remaining > 0) else 1
    return depth, W


# ---------------------------------------------------------------------------
# Host-side packing: per-prim params, pattern trees, lights.
# ---------------------------------------------------------------------------

# Per-prim row layout:
#  0-11  world->object affine [3,4]
# 12-20  normal matrix [3,3] (object normal -> world, unnormalized)
# 21     ymin   22 ymax   23 closed
# 24 ambient  25 diffuse  26 specular  27 shininess
# 28 reflective  29 transparency  30 ior   31 torus minor radius
P_COLS = 32
PAT_COLS = 17
L_COLS = 15


def _tri_groups(scene):
    """Static (shade class, pattern) grouping of the triangle prims ->
    (per-prim group id list, representative prim id per group)."""
    prim_gid = [0] * len(scene.prim_kinds)
    key_to_gid = {}
    reps = []
    for i, k in enumerate(scene.prim_kinds):
        if k != sd.TRIANGLE:
            continue
        key = (scene.prim_class_static[i], scene.prim_pattern_static[i])
        if key not in key_to_gid:
            key_to_gid[key] = len(reps)
            reps.append(i)
        prim_gid[i] = key_to_gid[key]
    return prim_gid, tuple(reps)


def prim_rows(scene):
    """Prim ids of the kernel's prim-table rows: the analytic prims, then
    one representative triangle per material group (row P + g holds
    group g's material and pattern; no row per triangle)."""
    analytic = [i for i, k in enumerate(scene.prim_kinds) if k != sd.TRIANGLE]
    return analytic + list(_tri_groups(scene)[1])


def pack_prims(scene, dtype=None):
    """[P + G, 32] prim table from the class shade table."""
    tbl = scene.cls_table.to(dtype or scene.dtype)
    cols = torch.cat([
        torch.arange(sd.CLS_INV, sd.CLS_INV + 12),
        torch.arange(sd.CLS_NMAT, sd.CLS_NMAT + 9),
        torch.tensor([sd.CLS_PMIN, sd.CLS_PMAX, sd.CLS_CLOSED,
                      sd.CLS_AMBIENT, sd.CLS_DIFFUSE, sd.CLS_SPECULAR,
                      sd.CLS_SHININESS, sd.CLS_REFLECTIVE,
                      sd.CLS_TRANSPARENCY, sd.CLS_IOR, sd.CLS_TORR])])
    classes = torch.tensor([scene.prim_class_static[i]
                            for i in prim_rows(scene)], dtype=torch.long)
    return tbl[classes.to(tbl.device)][:, cols.to(tbl.device)].contiguous()


def pack_tris(scene, dtype=None):
    """([Tp, 19] triangle table, [6, n_chunks + 1] chunk AABBs, the last
    column the whole mesh's box) for the in-kernel mesh (rray_tpu
    whitted.py pack_tris). Rows keep the Morton order; the table pads
    to whole MESH_CHUNK chunks with p1 = 1e30 and zero edges
    (degenerate: det == 0 misses), which the boxes leave out."""
    dtype = dtype or scene.dtype
    T = scene.counts[6]
    Tp = T + (-T) % MESH_CHUNK
    prim_gid, _ = _tri_groups(scene)
    gid = torch.tensor(prim_gid, dtype=dtype,
                       device=scene.device)[scene.tri_prim.long()]
    cols = [tbl[:, j].to(dtype) for tbl in (
        scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n1,
        scene.tri_n2, scene.tri_n3) for j in range(3)] + [gid]
    boxes = triangles.chunk_boxes(cols, MESH_CHUNK)
    tbl = torch.zeros((Tp, T_COLS), dtype=dtype, device=scene.device)
    tbl[T:, 0:3] = triangles.FAR
    tbl[:T] = torch.stack(cols, 1)
    return tbl, boxes


def pack_patterns(scene, dtype=None):
    """Flatten every pattern tree into one [N, 17] table plus static
    per-root descriptors (ptype, row, octaves, a_descr, b_descr), rows in
    pre-order (rray_tpu whitted.py:198-233). Node row layout: 0-11 inv
    affine [3,4], 12-14 color, 15 scale, 16 persistence. Image leaves'
    texels: pack_texels."""
    dtype = dtype or scene.dtype
    rows = []

    def walk(node):
        if node is None:
            return None
        idx = len(rows)
        rows.append(torch.cat([
            node.inv.reshape(12).to(dtype), node.color.reshape(3).to(dtype),
            node.scale.reshape(1).to(dtype),
            node.persistence.reshape(1).to(dtype)]))
        return (node.ptype, idx, int(node.octaves), walk(node.a),
                walk(node.b))

    descrs = tuple(walk(root) for root in scene.patterns)
    if not rows:
        return torch.zeros((0, PAT_COLS), dtype=dtype,
                           device=scene.device), descrs
    return torch.stack(rows), descrs


def pack_texels(scene, dtype=None):
    """(flat texel table [n], per image leaf (row, H, W, offset, format))
    for the kernel, image leaves in pack_patterns' row order. Format 0:
    one entry per texel holding the packed RGB8 value (an integer below
    2^24, exact in float32); format 1 (float textures): three entries
    per texel, r g b."""
    dtype = dtype or scene.dtype
    parts, meta = [], []
    count = {"row": 0, "off": 0}

    def walk(node):
        if node is None:
            return
        if node.ptype == "image":
            h, w = int(node.texture.shape[0]), int(node.texture.shape[1])
            fmt = 0 if node.texture.dtype == torch.int32 else 1
            parts.append(node.texture.reshape(-1).to(dtype))
            meta.append((count["row"], h, w, count["off"], fmt))
            count["off"] += parts[-1].numel()
        count["row"] += 1
        walk(node.a)
        walk(node.b)

    for root in scene.patterns:
        walk(root)
    if not parts:
        return None, ()
    return torch.cat(parts).contiguous(), tuple(meta)


def csg_meta(scene):
    """(member flag per kernel prim row, innermost-first (op, side per
    kernel prim row) list): rray_tpu's csg_meta (whitted.py:253-260) on
    the kernel's analytic prim rows (a CSG the kernel takes has no
    triangle operand)."""
    if not scene.csg_ops:
        return ((), ())
    rows = [i for i, k in enumerate(scene.prim_kinds) if k != sd.TRIANGLE]
    return (tuple(bool(scene.csg_member_static[i]) for i in rows),
            tuple((op, tuple(scene.csg_side_static[ci][i] for i in rows))
                  for ci, op in enumerate(scene.csg_ops)))


def pack_lights(scene, dtype=None):
    """[L, 15]: position(3), intensity(3), corner(3), uvec(3), vvec(3);
    the area extras are zeros for point lights."""
    dtype = dtype or scene.dtype
    z3 = torch.zeros(3, dtype=dtype, device=scene.device)
    rows = []
    for light in scene.lights:
        area = light.kind == "area"
        rows.append(torch.cat([
            light.position.to(dtype).reshape(3),
            light.intensity.to(dtype).reshape(3),
            light.corner.to(dtype).reshape(3) if area else z3,
            light.uvec.to(dtype).reshape(3) if area else z3,
            light.vvec.to(dtype).reshape(3) if area else z3]))
    if not rows:
        return torch.zeros((0, L_COLS), dtype=dtype, device=scene.device)
    return torch.stack(rows)


def light_levels(scene):
    """Per-light sample level: an area light's level (level^2 samples),
    0 for a point light (rray_tpu whitted.py light_meta)."""
    return tuple(int(light.level) if light.kind == "area" else 0
                 for light in scene.lights)


def kernel_inputs(scene, settings, seed=0):
    """Keyword arguments of `whitted_compact` (all but the rays) for a
    scene the kernel takes; `seed`, an int or a root key (ops/jitter.py
    seed_table), keys the area lights' jitter. The scene's tables are
    packed once per scene and (depth, W) (`SceneData.cached`; counter
    `table_builds`), so the bands of a progressive frame share them; the
    seed table is made per call."""
    depth, W = wavefront_shape(scene, settings)
    inputs = dict(scene.cached(("whitted", depth, W),
                               lambda: _scene_inputs(scene, depth, W),
                               grad=True))
    inputs["seeds"] = jitter.seed_table(seed, depth, len(scene.lights)).to(
        scene.device)
    return inputs


def _scene_inputs(scene, depth: int, W: int) -> dict:
    from . import build

    with profiling.span("tables"):
        pat_tbl, descrs = pack_patterns(scene)
        inputs = dict(
            prim_tbl=pack_prims(scene), pat_tbl=pat_tbl,
            light_tbl=pack_lights(scene),
            kinds=tuple(k for k in scene.prim_kinds if k != sd.TRIANGLE),
            pat_descrs=descrs,
            prim_pat=tuple(scene.prim_pattern_static[i]
                           for i in prim_rows(scene)),
            depth=depth, W=W, has_refl=scene.has_reflective,
            has_refr=scene.has_transparent, light_levels=light_levels(scene))
        if scene.counts[6]:
            inputs["tri_tbl"], inputs["tri_boxes"] = pack_tris(scene)
        if scene.csg_ops:
            inputs["csg"] = csg_meta(scene)
        tex_tbl, tex_meta = pack_texels(scene)
        if tex_tbl is not None:
            inputs["tex_tbl"], inputs["tex_meta"] = tex_tbl, tex_meta
        build.count(globals(), "table_builds")
    return inputs


def _light_args(light_tbl, light_levels, seeds, depth: int):
    """Checks one level per light and the [depth + 1, L] int32 seed table
    -> (levels as a tuple, seeds)."""
    L = light_tbl.shape[0]
    levels = tuple(light_levels)
    if len(levels) != L or any(lv < 0 for lv in levels):
        raise ValueError(f"light levels {levels} for {L} lights")
    if tuple(seeds.shape) != (depth + 1, L) or seeds.dtype != torch.int32:
        raise ValueError(f"seeds {tuple(seeds.shape)} {seeds.dtype}, "
                         f"expected ({depth + 1}, {L}) int32")
    return levels, seeds


# ---------------------------------------------------------------------------
# The plain version: rray_tpu's _node_row and _kernel on [R] tensors.
# ---------------------------------------------------------------------------

def _affine_pt(p, v: V3) -> V3:
    return V3(p[0] * v.x + p[1] * v.y + p[2] * v.z + p[3],
              p[4] * v.x + p[5] * v.y + p[6] * v.z + p[7],
              p[8] * v.x + p[9] * v.y + p[10] * v.z + p[11])


def _affine_vec(p, v: V3) -> V3:
    return V3(p[0] * v.x + p[1] * v.y + p[2] * v.z,
              p[4] * v.x + p[5] * v.y + p[6] * v.z,
              p[8] * v.x + p[9] * v.y + p[10] * v.z)


def _nmat_vec(p, v: V3) -> V3:
    return V3(p[12] * v.x + p[13] * v.y + p[14] * v.z,
              p[15] * v.x + p[16] * v.y + p[17] * v.z,
              p[18] * v.x + p[19] * v.y + p[20] * v.z)


def _scalar(x, dtype):
    """A table value as a 0-d tensor, so scalar arithmetic on it rounds
    in `dtype` exactly as the kernel's does."""
    return torch.tensor(x, dtype=dtype)


def _prim_slots(kind, p, o: V3, d: V3):
    if kind == sd.SPHERE:
        return soa._sphere_slots(o, d)
    if kind == sd.PLANE:
        return soa._plane_slots(o, d)
    if kind == sd.CUBE:
        return soa._cube_slots(o, d)
    if kind == sd.CYLINDER:
        return soa._cylinder_slots(o, d, p[21], p[22], p[23] != 0.0)
    if kind == sd.CONE:
        return soa._cone_slots(o, d, p[21], p[22], p[23] != 0.0)
    if kind == sd.TORUS:
        return soa._torus_slots(o, d, _scalar(p[31], o.x.dtype))
    raise ValueError(f"unsupported prim kind {kind}")


def _local_normal(kind, p, lp: V3) -> V3:
    """Per-kind local normal (rray_tpu whitted.py _local_normal)."""
    x, y, z = lp.x, lp.y, lp.z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    if kind == sd.SPHERE:
        return lp
    if kind == sd.PLANE:
        return V3(zero, one, zero)
    if kind == sd.CUBE:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        maxc = torch.maximum(ax, torch.maximum(ay, az))
        return V3(torch.where(maxc == ax, x, zero),
                  torch.where((maxc != ax) & (maxc == ay), y, zero),
                  torch.where((maxc != ax) & (maxc != ay), z, zero))
    if kind == sd.TORUS:
        r = _scalar(p[31], x.dtype)
        ss = x * x + y * y + z * z
        ps = 1.0 + r * r
        return V3(4.0 * x * (ss - ps), 4.0 * y * (ss - ps),
                  4.0 * z * (ss - ps + 2.0))
    cmin, cmax = _scalar(p[21], x.dtype), _scalar(p[22], x.dtype)
    dist = x * x + z * z
    top = (dist < 1.0) & (y >= cmax - EPSILON)
    bot = (dist < 1.0) & (y <= cmin + EPSILON)
    if kind == sd.CYLINDER:
        side_y = zero
    else:  # cone
        ny = torch.sqrt(torch.clamp_min(dist, 0.0))
        side_y = torch.where(y > 0.0, -ny, ny)
    cap = top | bot
    return V3(torch.where(cap, zero, x),
              torch.where(top, one, torch.where(bot, -one, side_y)),
              torch.where(cap, zero, z))


def _uv_kind(kind, p, pts: V3):
    """The uv mapping of a prim of `kind` (row p) on pattern-space points:
    shade_soa.uv_at's formulas with exact atan2 and acos (rray_tpu
    whitted.py _uv_kind substitutes polynomials for Mosaic), evaluated in
    float64 and rounded as the kernel does (ops/quartic.py f64_round: a
    texel index flips on an ulp)."""
    x, y, z = pts.x, pts.y, pts.z
    pi = math.pi

    def atan2(a, b):
        return quartic.f64_round(torch.atan2, a, b)

    def turn(angle):  # (angle + pi) / 2pi
        return div(angle + pi, 2.0 * pi)
    if kind == sd.SPHERE:
        theta = atan2(z, x)
        rr = torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        phi = quartic.f64_round(torch.acos, torch.clamp(y / rr, -1.0, 1.0))
        return turn(theta), 1.0 - div(phi, pi)
    if kind == sd.PLANE:
        return torch.remainder(x, 1.0), torch.remainder(z, 1.0)
    if kind == sd.CUBE:
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        fx = (ax >= ay) & (ax >= az)
        fy = ~fx & (ay >= ax) & (ay >= az)
        ur = torch.where(x > 0, (z + 1.0) * 0.5, (1.0 - z) * 0.5)
        uy = (x + 1.0) * 0.5
        vy = torch.where(y > 0, (1.0 - z) * 0.5, (z + 1.0) * 0.5)
        uz = torch.where(z > 0, (x + 1.0) * 0.5, (1.0 - x) * 0.5)
        return (torch.where(fx, ur, torch.where(fy, uy, uz)),
                torch.where(fy, vy, (y + 1.0) * 0.5))
    if kind in (sd.CYLINDER, sd.CONE):
        cmin, cmax = _scalar(p[21], x.dtype), _scalar(p[22], x.dtype)
        closed = p[23] != 0.0
    if kind == sd.CYLINDER:
        cap = closed & ((y <= cmin) | (y >= cmax))
        theta = atan2(z, x)
        return (torch.where(cap, (x + 1.0) / 2.0, turn(theta)),
                torch.where(cap, (z + 1.0) / 2.0, torch.remainder(y, 1.0)))
    if kind == sd.CONE:
        cap = closed & ((torch.abs(y - cmin) <= EPSILON)
                        | (torch.abs(y - cmax) <= EPSILON))
        radius = torch.clamp_min(torch.abs(y), 1e-30)
        theta = turn(atan2(z, x))
        height = cmax - cmin
        if abs(float(height)) < 1e-30:
            height = _scalar(1e-30, x.dtype)
        return (torch.where(cap, (x / radius + 1.0) / 2.0,
                            div(y - cmin, height)),
                torch.where(cap, (z / radius + 1.0) / 2.0, theta))
    if kind == sd.TORUS:
        dist = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-30)) - 1.0
        return turn(atan2(y, x)), turn(atan2(z, dist))
    raise ValueError(f"no uv mapping for prim kind {kind}")


def _texel(tex, row: int, pts_uv, dtype) -> V3:
    """The texel an image leaf (pattern row `row`) shows at (u, v), read
    from the flat texel table as the kernel reads it."""
    tex_tbl, tex_meta = tex
    _, h, w, off, fmt = next(m for m in tex_meta if m[0] == row)
    flat = shade_soa.texel_index(h, w, *pts_uv)
    if fmt == 0:
        return shade_soa.unpack_rgb8(tex_tbl[off + flat].to(torch.int64),
                                     dtype)
    base = off + 3 * flat
    return V3(tex_tbl[base], tex_tbl[base + 1], tex_tbl[base + 2])


def _eval_pattern(descr, pat, pts: V3, uv=None, tex=None) -> V3:
    """Pattern tree at pattern-space points (rray_tpu whitted.py
    _eval_pattern_tex, with an image leaf's texel read in place). `uv`
    maps a leaf's pattern-space points to (u, v) on the prim's shape;
    `tex` is (texel table, pack_texels meta)."""
    ptype, idx, meta, da, db = descr
    g = pat[idx]
    dtype = pts.x.dtype
    if ptype == "solid":
        return V3(torch.full_like(pts.x, g[12]), torch.full_like(pts.x, g[13]),
                  torch.full_like(pts.x, g[14]))
    p = _affine_pt(g, pts)
    if ptype == "image":
        return _texel(tex, idx, uv(p), dtype)
    if ptype == "perturbed":
        sc, per = _scalar(g[15], dtype), _scalar(g[16], dtype)
        nx = noise.octave_perlin(p.x, p.y, p.z, meta, per) * sc
        ny = noise.octave_perlin(p.x, p.y, p.z + 1.0, meta, per) * sc
        nz = noise.octave_perlin(p.x, p.y, p.z + 2.0, meta, per) * sc
        return _eval_pattern(da, pat, p + V3(nx, ny, nz), uv, tex)
    a = _eval_pattern(da, pat, p, uv, tex)
    b = _eval_pattern(db, pat, p, uv, tex)
    if ptype == "gradient":
        frac = p.x - torch.floor(p.x)
        return a + (b - a) * frac
    if ptype == "blend":
        s = _scalar(g[15], dtype)
        return a * (1.0 - s) + b * s
    if ptype == "noise":
        n = noise.octave_perlin(p.x, p.y, p.z, meta,
                                _scalar(g[16], dtype)) * _scalar(g[15], dtype)
        neg = n <= 0.0
        return V3(torch.where(neg, a.x * -n, b.x * n),
                  torch.where(neg, a.y * -n, b.y * n),
                  torch.where(neg, a.z * -n, b.z * n))
    if ptype == "stripe":
        cond = torch.remainder(torch.floor(p.x), 2.0) == 0.0
    elif ptype == "ring":
        cond = torch.remainder(torch.floor(torch.sqrt(p.x * p.x + p.z * p.z)),
                               2.0) == 0.0
    elif ptype == "checker":
        cond = torch.remainder(torch.floor(p.x) + torch.floor(p.y)
                               + torch.floor(p.z), 2.0) == 0.0
    else:
        raise ValueError(f"unsupported pattern {ptype}")
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def _member_slots(kinds, prims, csg, o: V3, d: V3, slots_of=None):
    """(t list, prim list, surviving valid list) of the CSG member slots
    on a world-space ray, in static (prim, slot) order, after the
    innermost-first filter (soa.csg_keeps). `slots_of(i)` gives prim i's
    slots when they are at hand."""
    member, ops_sides = csg
    ts, pids, valids = [], [], []
    for i, kind in enumerate(kinds):
        if not member[i]:
            continue
        p = prims[i]
        slots = slots_of(i) if slots_of else _prim_slots(
            kind, p, _affine_pt(p, o), _affine_vec(p, d))
        for t, valid in slots:
            ts.append(t)
            pids.append(i)
            valids.append(valid)
    ops_and_sides = tuple((op, tuple(side[i] for i in pids))
                          for op, side in ops_sides)
    return ts, pids, soa.csg_keeps(ts, valids, ops_and_sides)


def _blocked(kinds, prims, mesh, over: V3, dx, dy, dz, dist, csg=((), ())):
    """Is [0, dist) on the shadow ray from `over` blocked by an analytic
    prim, a CSG's surviving slot or the mesh? The predicate reads the
    16-col analytic layout (extras at 12-14); the 32-col prim rows keep
    them at 21-23. Tori test their slots; CSG members are filtered first
    (rray_tpu whitted.py:1086-1128)."""
    member = csg[0] or (False,) * len(kinds)
    occ = torch.zeros_like(dist, dtype=torch.bool)
    for kind, p, m in zip(kinds, prims, member):
        if m:
            continue
        if kind == sd.TORUS:
            for t, valid in _prim_slots(kind, p, _affine_pt(p, over),
                                        _affine_vec(p, V3(dx, dy, dz))):
                occ = occ | (valid & (t >= 0.0) & (t < dist))
            continue
        occ = occ | _occludes(kind, lambda j, p=p: p[j + 9 if j >= 12 else j],
                              over.x, over.y, over.z, dx, dy, dz, dist)
    if any(member):
        ts, _, keeps = _member_slots(kinds, prims, csg, over, V3(dx, dy, dz))
        for t, keep in zip(ts, keeps):
            occ = occ | (keep & (t >= 0.0) & (t < dist))
    if mesh is not None:
        occ = occ | (triangles.any_triangle_reference(
            (over.x, over.y, over.z), (dx, dy, dz), mesh[0], dist) != 0)
    return occ


def _shadow_frac(kinds, prims, mesh, L, level: int, seed: int, over: V3,
                 csg=((), ())):
    """Shadowed fraction of light row L at `over` (rray_tpu whitted.py
    :1138-1164): binary for a point light (level 0); for an area light
    the blocked share of its level^2 jittered samples, drawn with the
    hash base point_base(seed, over) and scaled as cnt * float(1/n)."""
    dtype = over.x.dtype
    if level == 0:
        to = V3(L[0] - over.x, L[1] - over.y, L[2] - over.z)
        dist = to.norm()
        direction = to * (1.0 / torch.clamp_min(dist, 1e-30))
        return _blocked(kinds, prims, mesh, over, direction.x, direction.y,
                        direction.z, dist, csg).to(dtype)
    n = level * level
    hb = jitter.point_base(seed, over.x, over.y, over.z)
    cnt = torch.zeros_like(over.x)
    for s in range(n):
        direction, dist = area_sample(L[6:15], hb, s, level, over)
        cnt = cnt + _blocked(kinds, prims, mesh, over, direction.x,
                             direction.y, direction.z, dist, csg).to(dtype)
    return cnt * _scalar(1.0 / n, dtype)


def closest_hit(kinds, prims, mesh, o: V3, d: V3, csg=((), ())):
    """The node's closest hit -> (best t, winning prim-table row or -1,
    each analytic prim's slots, mesh-winner mask, the mesh winner's
    interpolated normal; the last two None without a mesh). Per-prim
    minimum, then a strict < across prims, so the lowest prim id wins
    ties; the mesh folds after the analytic prims, bounded by their best
    t; the CSG members' filtered slots fold last."""
    inf = torch.full_like(o.x, float("inf"))
    P = len(kinds)
    member = csg[0] or (False,) * P
    slots_per_prim = []
    mesh_win = mesh_n = None
    best_t = inf
    win = torch.full(o.x.shape, -1, dtype=torch.long, device=o.x.device)
    for i, kind in enumerate(kinds):
        p = prims[i]
        slots = _prim_slots(kind, p, _affine_pt(p, o), _affine_vec(p, d))
        slots_per_prim.append(slots)
        if member[i]:
            continue
        tp = inf
        for t, valid in slots:
            tp = torch.minimum(tp, torch.where(valid & (t >= 0.0), t, inf))
        better = tp < best_t
        best_t = torch.where(better, tp, best_t)
        win = torch.where(better, i, win)
    if mesh is not None:
        # The mesh fold after the analytic prims, bounded by their best t
        # (rray_tpu _mesh_closest); a mesh winner's row is its group's.
        geom, gid = mesh
        mt, _, _, _, mnx, mny, mnz, mgid = triangles.closest_triangle_reference(
            (o.x, o.y, o.z), (d.x, d.y, d.z), geom, t_init=best_t,
            aux=(gid,))
        mesh_win = mt < best_t
        mesh_n = V3(mnx, mny, mnz)
        best_t = torch.where(mesh_win, mt, best_t)
        win = torch.where(mesh_win, P + mgid.long(), win)
    if any(member):
        # The CSG-filtered member slots, folded after the non-members and
        # the mesh with a strict < (rray_tpu whitted.py:902-924).
        ts, pids, keeps = _member_slots(kinds, prims, csg, o, d,
                                        slots_of=slots_per_prim.__getitem__)
        for t, pid, keep in zip(ts, pids, keeps):
            cand = keep & (t >= 0.0) & (t < best_t)
            best_t = torch.where(cand, t, best_t)
            win = torch.where(cand, pid, win)
            if mesh is not None:
                mesh_win = mesh_win & ~cand
    return best_t, win, slots_per_prim, mesh_win, mesh_n


def _node(kinds, pat_descrs, prim_pat, has_refl, has_refr, prims, pat,
          lights, levels, seeds, mesh, o: V3, d: V3, csg=((), ()), tex=None):
    """One Whitted node over a batch of rays (rray_tpu whitted.py
    _node_row). `prims` holds the P = len(kinds) analytic rows, then one
    row per mesh material group; `levels` the per-light sample level (0:
    point light) and `seeds` this level's per-light jitter seeds; `mesh`
    is None or (the triangle table's 18 geometry columns, its group-id
    column); `csg` is csg_meta's (member flags, (op, sides) list) on the
    analytic rows; `tex` is None or (texel table, pack_texels meta).

    Returns (surface, over, under, reflectv, refr_dir, refl_w, refr_w)."""
    dtype = o.x.dtype
    inf = torch.full_like(o.x, float("inf"))
    P = len(kinds)
    best_t, win, slots_per_prim, mesh_win, mesh_n = closest_hit(
        kinds, prims, mesh, o, d, csg)
    found = torch.isfinite(best_t)
    t_safe = torch.where(found, best_t, 0.0)
    point = o + d * t_safe
    eyev = -d

    # Normal: the winner's kind formula on its object-space point,
    # through its normal matrix, with the eye flip.
    zero = torch.zeros_like(o.x)
    nsel = V3(zero, zero, zero)
    for i, kind in enumerate(kinds):
        p = prims[i]
        n = _nmat_vec(p, _local_normal(kind, p, _affine_pt(p, point)))
        m = win == i
        nsel = V3(torch.where(m, n.x, nsel.x), torch.where(m, n.y, nsel.y),
                  torch.where(m, n.z, nsel.z))
    if mesh is not None:
        # Mesh winners carry the interpolated world vertex normal.
        nsel = V3(torch.where(mesh_win, mesh_n.x, nsel.x),
                  torch.where(mesh_win, mesh_n.y, nsel.y),
                  torch.where(mesh_win, mesh_n.z, nsel.z))
    normalv = nsel.normalize()
    inside = normalv.dot(eyev) < 0.0
    normalv = normalv * torch.where(inside, -1.0, 1.0).to(dtype)
    eps = offset_eps(dtype)
    over = point + normalv * eps
    under = point - normalv * eps

    # n1/n2: crossing-parity folds over the same slots.
    if has_refr:
        t_hit = torch.where(found, best_t, -1.0)
        tol = hit_match_tol(dtype) * torch.clamp_min(torch.abs(t_hit), 1.0)
        neg = -inf
        bts, btl = neg, neg
        ior_s = ior_l = torch.ones_like(o.x)
        for i, slots in enumerate(slots_per_prim):
            cnt_s = cnt_l = torch.zeros_like(o.x, dtype=torch.int32)
            last_s = last_l = neg
            for t, valid in slots:
                is_hit = (win == i) & (torch.abs(t - t_hit) <= tol)
                before = valid & (t < t_hit)
                in_s = before & ~is_hit
                in_l = before | (valid & is_hit)
                cnt_s = cnt_s + in_s.to(torch.int32)
                last_s = torch.maximum(last_s, torch.where(in_s, t, neg))
                cnt_l = cnt_l + in_l.to(torch.int32)
                last_l = torch.maximum(last_l, torch.where(in_l, t, neg))
            ior_i = prims[i][30]
            bs = ((cnt_s % 2) == 1) & (last_s > bts)
            bts = torch.where(bs, last_s, bts)
            ior_s = torch.where(bs, ior_i, ior_s)
            bl = ((cnt_l % 2) == 1) & (last_l > btl)
            btl = torch.where(bl, last_l, btl)
            ior_l = torch.where(bl, ior_i, ior_l)
        n1 = torch.where(torch.isfinite(bts) & (bts > -inf), ior_s, 1.0)
        n2 = torch.where(torch.isfinite(btl) & (btl > -inf), ior_l, 1.0)
    else:
        n1 = n2 = torch.ones_like(o.x)

    # Pattern at the over point, on the winner's object space (a mesh
    # group's: its class row's); an image leaf maps its points to uv on
    # the winner's shape. Trees no ray hit are skipped: their values
    # would be masked out.
    base = V3(zero, zero, zero)
    for i in range(len(prims)):
        m = win == i
        if not bool(m.any()):
            continue
        uv = (lambda q, i=i: _uv_kind(kinds[i], prims[i], q)) if i < P \
            else None
        col = _eval_pattern(pat_descrs[prim_pat[i]], pat,
                            _affine_pt(prims[i], over), uv, tex)
        base = V3(torch.where(m, col.x, base.x), torch.where(m, col.y, base.y),
                  torch.where(m, col.z, base.z))

    # Material columns of the winner (24-30), zeros where nothing was hit.
    mats = torch.tensor([row[24:31] for row in prims], dtype=dtype,
                        device=o.x.device)
    sel = torch.where(found[:, None], mats[win.clamp_min(0)], 0.0)
    amb, dif, spe, shi, reflective, transparency = sel.unbind(1)[:6]

    # Phong per light (light.rs:98-140), shaded from the light's position
    # (an area light's centre, light.rs:41-45), with its shadowed
    # fraction.
    surface = V3(zero, zero, zero)
    for L, level, seed in zip(lights, levels, seeds):
        unshadow = 1.0 - _shadow_frac(kinds, prims, mesh, L, level, seed,
                                      over, csg)
        effective = V3(base.x * L[3], base.y * L[4], base.z * L[5])
        lightv = V3(L[0] - over.x, L[1] - over.y, L[2] - over.z).normalize()
        ambient = effective * amb
        ldn = lightv.dot(normalv)
        lit = ldn >= 0.0
        dscale = torch.where(lit, dif * ldn, 0.0)
        rde = (-lightv).reflect(normalv).dot(eyev)
        spec_on = lit & (rde > 0.0)
        factor = torch.pow(torch.clamp_min(rde, 1e-30), shi)
        sscale = torch.where(spec_on, spe * factor, 0.0)
        surface = V3(
            surface.x + ambient.x + (effective.x * dscale
                                     + L[3] * sscale) * unshadow,
            surface.y + ambient.y + (effective.y * dscale
                                     + L[4] * sscale) * unshadow,
            surface.z + ambient.z + (effective.z * dscale
                                     + L[5] * sscale) * unshadow)
    surface = V3(torch.where(found, surface.x, 0.0),
                 torch.where(found, surface.y, 0.0),
                 torch.where(found, surface.z, 0.0))
    reflectv = d.reflect(normalv)

    # Refraction + TIR + Schlick (scene.rs:310-336, computations.rs:39-54).
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
    if has_refl and has_refr:
        both = (reflective > 0.0) & (transparency > 0.0)
        cos_eff = torch.where(n1 > n2, cos_t, cos_i)
        q = (n1 - n2) / (n1 + n2)
        r0 = q * q
        m = 1.0 - cos_eff
        m2 = m * m
        m5 = m * (m2 * m2)  # the multiply order of lax.integer_pow(m, 5)
        reflectance = r0 + (1.0 - r0) * m5
        reflectance = torch.where((n1 > n2) & (sin2_t > 1.0), 1.0,
                                  reflectance)
        refl_w = torch.where(both, reflective * reflectance, refl_w)
        refr_w = torch.where(both, refr_w * (1.0 - reflectance), refr_w)
    return surface, over, under, reflectv, refr_dir, refl_w, refr_w


def whitted_compact_reference(ro_comps, rd_comps, prim_tbl, pat_tbl,
                              light_tbl, kinds, pat_descrs, prim_pat,
                              depth: int, W: int, has_refl: bool,
                              has_refr: bool, tri_tbl=None, tri_boxes=None,
                              *, light_levels, seeds, csg=((), ()),
                              tex_tbl=None, tex_meta=()):
    """Plain PyTorch version of the kernel -> (r, g, b) [R] tensors.
    `tri_boxes` only culls in the kernel; the plain version tests every
    triangle (padding rows included: they never hit). Level l's area
    lights draw with seeds[l].

    Every level evaluates all W path rows of every pixel at once
    ([W*R] tensors). A row of weight 0 contributes nothing, as the
    kernel skips it. When both reflection and refraction spawn, the 2W
    children are ordered by a stable descending sort of their weights
    and the first W survive — the order the kernel's odd-even
    transposition network (swap on strict <) produces for weights >= 0."""
    dtype = ro_comps[0].dtype
    prims, pat, lights = prim_tbl.tolist(), pat_tbl.tolist(), \
        light_tbl.tolist()
    levels, seeds = _light_args(light_tbl, light_levels, seeds, depth)
    seeds = seeds.tolist()
    mesh = None
    if tri_tbl is not None:
        cols = tri_tbl.unbind(1)
        mesh = (cols[:18], cols[18])
    R = ro_comps[0].shape[0]
    both = has_refl and has_refr
    spawn = 2 if both else (1 if (has_refl or has_refr) else 0)
    if W != 1 and not both:
        raise ValueError("W > 1 needs both reflection and refraction")

    # state[c, r]: component c (origin xyz, direction xyz, weight) of
    # path row r; rows 1..W-1 start dead (weight 0, +z direction).
    st = torch.zeros((7, W, R), dtype=dtype, device=ro_comps[0].device)
    st[5] = 1.0
    for c, v in enumerate(tuple(ro_comps) + tuple(rd_comps)):
        st[c, 0] = v
    st[6, 0] = 1.0
    acc = [torch.zeros_like(ro_comps[0]) for _ in range(3)]
    for level in range(depth + 1):
        rows = st.reshape(7, W * R)
        w = rows[6]
        surface, over, under, reflectv, refr_dir, refl_w, refr_w = _node(
            kinds, pat_descrs, prim_pat, has_refl, has_refr, prims, pat,
            lights, levels, seeds[level], mesh, V3(rows[0], rows[1], rows[2]),
            V3(rows[3], rows[4], rows[5]), csg,
            None if tex_tbl is None else (tex_tbl, tex_meta))
        for c, v in enumerate((surface.x, surface.y, surface.z)):
            contrib = torch.where(w != 0.0, v * w, 0.0).reshape(W, R)
            for r in range(W):
                acc[c] = acc[c] + contrib[r]
        if level == depth or not spawn:
            break
        # Children [7, spawn*W, R]: reflection rows first, then refraction.
        refl = (over, reflectv, w * refl_w)
        refr = (under, refr_dir, w * refr_w)
        children = [refl, refr] if spawn == 2 else \
            [refl if has_refl else refr]
        ch = torch.stack([
            torch.cat([(pt.x, pt.y, pt.z, dr.x, dr.y, dr.z, cw)[c]
                       .reshape(W, R) for pt, dr, cw in children])
            for c in range(7)])
        if spawn == 2:
            order = torch.sort(ch[6], dim=0, descending=True,
                               stable=True).indices[:W]
            ch = torch.gather(ch, 1, order.expand(7, W, R))
        st = ch[:, :W].contiguous()
    return tuple(acc)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper.
# ---------------------------------------------------------------------------

def _descr_depth(descr) -> int:
    if descr is None:
        return 0
    return 1 + max(_descr_depth(descr[3]), _descr_depth(descr[4]))


def _descr_names(descr):
    if descr is None:
        return set()
    return {descr[0]} | _descr_names(descr[3]) | _descr_names(descr[4])


def uses_ext(kinds, pat_descrs, csg) -> bool:
    """Do these kernel inputs need stage e (CSG, a torus, a noise,
    perturbed or image pattern node)? needs_ext on the packed form."""
    return bool(csg[1]) or sd.TORUS in kinds or any(
        _descr_names(d) - set(CHEAP_PATTERNS) for d in pat_descrs)


def pattern_program(pat_descrs, prim_pat):
    """Flatten pack_patterns' trees into the kernel's pattern program ->
    (instructions [op, row, target, aux], the program start of every
    prim-table row, the stack frames a thread needs).

    Each tree is emitted in pre-order with its control ops
    (csrc/whitted_device.cuh eval_program runs them): a stripe, ring,
    checker or noise node is followed by child a's code, a jump over
    child b's, and child b's code, its `target` the start of b's code,
    so the kernel runs only the child the node shows (a noise node also
    pushes its factor, which POPSCALE after b applies); a perturbed
    node's child follows it; a gradient or blend node pushes its point,
    then come a's code, MID, b's code and COMBINE (aux: the node type).
    Frames: one per pending gradient, blend or noise node."""
    prog = []
    n_children = {"solid": 0, "image": 0, "perturbed": 1}

    def emit(descr) -> int:
        name, row, _, da, db = descr
        if name not in PATTERN_CODES:
            raise ValueError(f"the kernel takes no {name!r} pattern")
        if sum(c is not None for c in (da, db)) != n_children.get(name, 2):
            raise ValueError(f"{name} pattern node with children {da, db}")
        code = PATTERN_CODES[name]
        at = len(prog)
        prog.append([code, row, 0, 0])
        if name in ("solid", "image"):
            return 0
        if name == "perturbed":
            return emit(da)
        if name in ("gradient", "blend"):
            fa = emit(da)
            prog.append([OP_MID, 0, 0, 0])
            fb = emit(db)
            prog.append([OP_COMBINE, row, 0, code])
            return 1 + max(fa, fb)
        fa = emit(da)
        jump = len(prog)
        prog.append([OP_JUMP, 0, 0, 0])
        prog[at][2] = len(prog)
        fb = emit(db)
        prog[jump][2] = len(prog)
        if name == "noise":
            prog.append([OP_POPSCALE, 0, 0, 0])
            return 1 + max(fa, fb)
        return max(fa, fb)

    starts, frames = [], 0
    for descr in pat_descrs:
        starts.append(len(prog))
        frames = max(frames, emit(descr))
        prog.append([OP_END, 0, 0, 0])
    return prog, [starts[p] for p in prim_pat], frames


# Hit slots per prim kind (csrc/whitted_device.cuh's slot forms).
SLOTS_PER_KIND = {sd.SPHERE: 2, sd.PLANE: 1, sd.CUBE: 2, sd.CYLINDER: 4,
                  sd.CONE: 5, sd.TORUS: 4}


def slot_bucket(kinds, csg) -> int:
    """The CSG member-slot bucket of the stage-e kernel at W = 1: the
    smallest of SLOT_BUCKETS that holds the scene's member slots."""
    member = csg[0] or (False,) * len(kinds)
    K = sum(SLOTS_PER_KIND[k] for k, m in zip(kinds, member) if m)
    return next(b for b in SLOT_BUCKETS if K <= b)



def tile_ray_index(R: int, width: int = 0):
    """The kernel's ray per (tile, thread) slot, -1 where the slot is
    masked: csrc/whitted.cu tile_ray, mirrored. With a raster width,
    tiles are 16x8 pixels in row-major tile order, warp w of a tile
    covering the 8x4 sub-tile (w % 2, w // 2) and lane l its pixel
    (l % 8, l // 8); without one, tile k holds rays [128 k, 128 k + 128)."""
    t = torch.arange(THREADS)
    if width <= 0:
        i = torch.arange((R + THREADS - 1) // THREADS)[:, None] * THREADS + t
        return torch.where(i < R, i, -1).reshape(-1)
    rows = (R + width - 1) // width
    tiles_x = (width + TILE_W - 1) // TILE_W
    tiles = tiles_x * ((rows + TILE_H - 1) // TILE_H)
    tile = torch.arange(tiles)[:, None]
    warp, lane = t // 32, t % 32
    x = (tile % tiles_x) * TILE_W + (warp % 2) * 8 + lane % 8
    y = (tile // tiles_x) * TILE_H + (warp // 2) * 4 + lane // 8
    i = y * width + x
    return torch.where((x < width) & (i < R), i, -1).reshape(-1)


class KernelTables(NamedTuple):
    """One launch's staged tables: `tables` int32 words (float tables
    bit for bit) on the inputs' device, `desc` the DESC_FIELDS words,
    `ext`, the slot bucket `KB`, `smem` bytes of dynamic shared memory
    (the tables and THREADS pattern stacks of `frames` frames), `sizes`
    the bytes of each table, for the error message."""
    tables: torch.Tensor
    desc: list
    ext: bool
    KB: int
    smem: int
    frames: int
    sizes: dict


def kernel_tables(prim_tbl, pat_tbl, light_tbl, kinds, pat_descrs, prim_pat,
                  depth, W, has_refl, has_refr, tri_tbl=None, tri_boxes=None,
                  *, light_levels, seeds, csg=((), ()), tex_meta=(), R=0,
                  width=0) -> KernelTables:
    """Pack the kernel's inputs into the block of tables it stages in
    shared memory (csrc/whitted_device.cuh Scene): float rows prims [P +
    G, 32], pats [N, 17], lights [L, 15]; ints kinds [P], the pattern
    program start of every prim row [P + G], the program [n, 4], light
    levels [L], jitter seeds [depth + 1, L]; for stage e pattern meta [N,
    4] (noise and perturbed: octaves; image: H, W, texel offset, format),
    CSG member flags [P], ops [C] and sides [C, P] innermost first; the
    mesh rows [Tp, 19] and chunk boxes [6, n_chunks + 1]. Each table
    starts on a 16-byte boundary, as the bulk copy moves whole 16-byte
    units. These are rray_tpu's trace-time statics as data the CUDA
    kernel interprets."""
    P, N, L = len(kinds), pat_tbl.shape[0], light_tbl.shape[0]
    ext = uses_ext(kinds, pat_descrs, csg)
    prog, roots, frames = pattern_program(pat_descrs, prim_pat)
    member, ops_sides = csg
    parts, desc = [], dict.fromkeys(DESC_FIELDS, 0)
    sizes = {}

    def words(t):
        return t.detach().to("cpu", torch.float32).contiguous().reshape(
            -1).view(torch.int32).numpy()

    def add(name, arr, label):
        desc[name] = sum(len(a) for a in parts)
        arr = np.asarray(arr, np.int32).reshape(-1)
        sizes[label] = 4 * len(arr)
        parts.append(np.concatenate(
            [arr, np.zeros((-len(arr)) % 4, np.int32)]))

    add("prims", words(prim_tbl), "prims")
    add("pats", words(pat_tbl), "pattern rows")
    add("lights", words(light_tbl), "lights")
    add("kinds", list(kinds), "prim kinds")
    add("roots", roots, "pattern roots")
    add("prog", prog or [[OP_END, 0, 0, 0]], "pattern programs")
    add("levels", list(light_levels), "light levels")
    add("seeds", seeds.detach().cpu().numpy(), "jitter seeds")
    if ext:
        meta = [[0, 0, 0, 0] for _ in range(N)]

        def walk(descr):
            if descr is not None:
                if descr[0] in ("noise", "perturbed"):
                    meta[descr[1]][0] = descr[2]
                walk(descr[3])
                walk(descr[4])

        for descr in pat_descrs:
            walk(descr)
        for row, h, w, off, fmt in tex_meta or ():
            meta[row] = [h, w, off, fmt]
        add("pmeta", meta, "pattern meta")
        add("member", [int(m) for m in member or (False,) * P],
            "CSG members")
        add("csg_ops", [op for op, _ in ops_sides], "CSG ops")
        add("csg_side", [v for _, side in ops_sides for v in side],
            "CSG sides")
    if tri_tbl is not None:
        add("tris", words(tri_tbl), "mesh")
        add("tboxes", words(tri_boxes), "mesh chunk boxes")
        desc["T"] = tri_tbl.shape[0]
        desc["n_chunks"] = tri_boxes.shape[1] - 1
    desc.update(P=P, L=L, C=len(ops_sides), depth=depth,
                has_refl=int(has_refl), has_refr=int(has_refr),
                width=int(width or 0), R=R,
                words=sum(len(a) for a in parts))
    stack = 4 * frames * FRAME_WORDS * THREADS
    sizes["pattern stacks"] = stack
    tables = torch.from_numpy(np.concatenate(parts)).to(prim_tbl.device)
    return KernelTables(tables, [desc[k] for k in DESC_FIELDS], ext,
                        slot_bucket(kinds, csg) if ext and W == 1 else 0,
                        4 * desc["words"] + stack, frames, sizes)


def _launch(ro_comps, rd_comps, prim_tbl, pat_tbl, light_tbl, kinds,
            pat_descrs, prim_pat, depth, W, has_refl, has_refr, tri_tbl=None,
            tri_boxes=None, *, light_levels, seeds, csg=((), ()),
            tex_tbl=None, tex_meta=(), width=None):
    from . import build

    device = ro_comps[0].device
    R = ro_comps[0].shape[0]
    P, N, L = len(kinds), pat_tbl.shape[0], light_tbl.shape[0]
    G = len(prim_pat) - P
    for k, c in enumerate(tuple(ro_comps) + tuple(rd_comps)):
        build.check_arg(f"ray component {k}", c, (R,), device)
    build.check_arg("prim_tbl", prim_tbl, (P + G, P_COLS), device)
    build.check_arg("pat_tbl", pat_tbl, (N, PAT_COLS), device)
    build.check_arg("light_tbl", light_tbl, (L, L_COLS), device)
    if W not in WIDTHS:
        raise ValueError(f"W={W}; the kernel is built for W in {WIDTHS}")
    if W != 1 and not (has_refl and has_refr):
        raise ValueError("W > 1 needs both reflection and refraction")
    if P > MAX_PRIMS or any(k not in OCCLUSION_KINDS + (sd.TORUS,)
                            for k in kinds):
        raise ValueError(f"the kernel takes at most {MAX_PRIMS} analytic "
                         f"sphere/plane/cube/cylinder/cone/torus prims: "
                         f"{kinds}")
    if N > MAX_PATTERN_ROWS or L > MAX_LIGHTS or any(
            _descr_depth(d) > MAX_PATTERN_DEPTH for d in pat_descrs):
        raise ValueError("pattern or light tables past the kernel's bounds")
    if depth < 0:
        raise ValueError(f"depth={depth}")
    if width is not None and not 0 < width <= max(R, 1):
        raise ValueError(f"raster width {width} for {R} rays")
    levels, seeds = _light_args(light_tbl, light_levels, seeds, depth)
    build.check_arg("seeds", seeds, (depth + 1, L), device, torch.int32)
    member, ops_sides = csg
    C = len(ops_sides)
    if C and (len(member) != P or any(len(side) != P for _, side in ops_sides)
              or has_refr):
        raise ValueError(f"CSG tables for {P} prims (and no refraction) "
                         f"expected: {csg}")
    if tex_tbl is not None:
        n_tex = tex_tbl.shape[0]
        build.check_arg("tex_tbl", tex_tbl, (n_tex,), device)
        if n_tex >= 3 * MAX_TEXELS or depth:
            raise ValueError(f"a texel table of {n_tex} entries at depth "
                             f"{depth}: the kernel takes textures below "
                             f"{MAX_TEXELS} texels at depth 0")
    if tri_tbl is not None:
        Tp, n_chunks = tri_tbl.shape[0], tri_boxes.shape[1] - 1
        build.check_arg("tri_tbl", tri_tbl, (Tp, T_COLS), device)
        build.check_arg("tri_boxes", tri_boxes, (6, n_chunks + 1), device)
        if Tp > MESH_MAX_TRIS + MESH_CHUNK or Tp % MESH_CHUNK \
                or n_chunks != Tp // MESH_CHUNK or not 0 < G <= MAX_GROUPS:
            raise ValueError(f"mesh of {Tp} rows, {n_chunks} chunks, {G} "
                             "groups: past the kernel's bounds")
        if has_refr:
            raise ValueError("the in-kernel mesh takes no refraction")
    elif G or P == 0:
        raise ValueError(f"{P} prims and {G} group rows without a mesh")
    kt = kernel_tables(prim_tbl, pat_tbl, light_tbl, kinds, pat_descrs,
                       prim_pat, depth, W, has_refl, has_refr, tri_tbl,
                       tri_boxes, light_levels=levels, seeds=seeds, csg=csg,
                       tex_meta=tex_meta, R=R, width=width)
    if kt.smem > SMEM_BYTES:
        tables = ", ".join(f"{k} {v}" for k, v in kt.sizes.items() if v)
        raise ValueError(f"{kt.smem} bytes of scene tables and pattern "
                         f"stacks ({tables}) past the {SMEM_BYTES} bytes of "
                         f"shared memory a block may opt in to on Hopper")
    outs = [torch.empty(R, dtype=torch.float32, device=device)
            for _ in range(3)]
    # The tile scheduler's counter: tiles taken past the persistent grid.
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    desc = (ctypes.c_int * len(kt.desc))(*kt.desc)
    blocks = ctypes.c_int(0)
    ptr = build.ptr
    with torch.cuda.device(device):
        rc = build.load_library().whitted_compact_launch(
            *(ptr(c) for c in tuple(ro_comps) + tuple(rd_comps)),
            *(ptr(o) for o in outs), ptr(kt.tables), desc, ptr(tex_tbl),
            ptr(counter), W, int(kt.ext), kt.KB, kt.smem,
            ctypes.byref(blocks),
            build.stream(device))
    build.check_launch("whitted", rc)
    build.count(globals(), "launches")
    last_launch.update(W=W, ext=kt.ext, KB=kt.KB, smem=kt.smem,
                       blocks_per_sm=blocks.value)
    return tuple(outs)


def blocks_per_sm(W: int, ext: bool, KB: int, smem: int) -> int:
    """Resident blocks per SM of one kernel instantiation at `smem` bytes
    of dynamic shared memory (the occupancy calculator on the current
    card); raises on a CUDA error."""
    from . import build

    n = build.load_library().whitted_blocks_per_sm(W, int(ext), KB, smem)
    if n < 0:
        build.check_launch("whitted occupancy", -n)
    return n


def whitted_compact(ro_comps, rd_comps, prim_tbl, pat_tbl, light_tbl,
                    kinds, pat_descrs, prim_pat, depth: int, W: int,
                    has_refl: bool, has_refr: bool, tri_tbl=None,
                    tri_boxes=None, *, light_levels, seeds, csg=((), ()),
                    tex_tbl=None, tex_meta=(), width=None):
    """Whitted evaluation of [R] primary rays -> (r, g, b) [R] tensors.

    ro/rd_comps: 3-tuples of [R] tensors; prim_tbl [P+G,32], pat_tbl
    [N,17], light_tbl [L,15], tri_tbl [Tp,19] and tri_boxes
    [6,Tp/24+1] (see pack_*; kernel_inputs builds them all); kinds are
    the P analytic prim kinds, pat_descrs pack_patterns' descriptors,
    prim_pat the pattern root of each prim-table row; light_levels each
    light's sample level (0: point light) and seeds the [depth+1, L]
    int32 jitter seeds (ops/jitter.py seed_table); csg is csg_meta's
    (member flags, (op, sides) list), tex_tbl/tex_meta pack_texels'
    texel table and image-leaf meta. `width` is the raster width of
    camera rays in row-major order: the kernel then shades them in 16x8
    pixel tiles (tile_ray_index); without it, rays keep row order. The
    result is the same either way. CPU tensors run the plain version
    (which ignores `width`); CUDA tensors launch the kernel (float32
    only)."""
    args = (ro_comps, rd_comps, prim_tbl, pat_tbl, light_tbl, kinds,
            pat_descrs, prim_pat, depth, W, has_refl, has_refr, tri_tbl,
            tri_boxes)
    kw = dict(light_levels=light_levels, seeds=seeds, csg=csg,
              tex_tbl=tex_tbl, tex_meta=tex_meta)
    if ro_comps[0].device.type == "cpu":
        return whitted_compact_reference(*args, **kw)
    return _launch(*args, **kw, width=width)
