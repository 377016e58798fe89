"""Scene representation: host-side construction + device-side SoA tables.

The host description (Pattern, Material, Shape, lights) is rray_tpu's,
so the YAML and OBJ loaders carry over unchanged. `compile_scene` folds
the scene graph into the same flat tables as rray_tpu's compile_scene:
per-leaf composed world->object affines and normal matrices, the
[M, 34] class shade table (`CLS_*` columns), per-type affines, pattern
trees and lights. Group transform chains fold at build time, which is
exact because per-level normalization only rescales directions.

The tables are torch tensors on the caller's device, in a plain
dataclass; structural facts (counts, prim kinds, pattern node types,
light kinds) are plain Python fields. The port compiles analytic
leaves, triangles (Morton-ordered, mesh triangles collapsed to one shade
class), groups and CSG nodes (membership tables innermost first, with
the reference's `includes()` quirk: see `_walk`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import mathutils as mu
from ..config import checked_device
from ..utils import profiling

# Primitive type codes.
SPHERE, PLANE, CUBE, CYLINDER, CONE, TORUS, TRIANGLE = range(7)

# cls_table column layout (one row per shade class; every analytic leaf
# is its own class).
CLS_INV = 0          # 12 cols: world->object affine, row-major [3,4]
CLS_NMAT = 12        # 9 cols: object-normal -> world matrix [3,3]
CLS_TYPE = 21        # type code (exact small int in float)
CLS_PATTERN = 22     # pattern root index
CLS_AMBIENT = 23
CLS_DIFFUSE = 24
CLS_SPECULAR = 25
CLS_SHININESS = 26
CLS_REFLECTIVE = 27
CLS_TRANSPARENCY = 28
CLS_IOR = 29
CLS_PMIN = 30        # cylinder/cone minimum (by type)
CLS_PMAX = 31        # cylinder/cone maximum
CLS_CLOSED = 32      # cylinder/cone closed flag (0/1)
CLS_TORR = 33        # torus minor radius
CLS_COLS = 34

# CSG operation codes.
CSG_UNION, CSG_INTERSECTION, CSG_DIFFERENCE = range(3)
_CSG_OPS = {"union": CSG_UNION, "intersection": CSG_INTERSECTION,
            "difference": CSG_DIFFERENCE}

# Hit slots that each analytic primitive contributes to a ray's slot
# list (ops/intersect.py).
SLOTS_PER_TYPE = {SPHERE: 2, PLANE: 1, CUBE: 2, CYLINDER: 4, CONE: 5, TORUS: 4}


# --------------------------------------------------------------------------
# Host-side pattern / material / shape description (what the YAML loader and
# tests construct).
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Pattern:
    """Host pattern-tree node (material/pattern.rs:26-37)."""

    ptype: str  # solid|test|stripe|gradient|ring|checker|blend|perturbed|noise|image
    transform: np.ndarray = dataclasses.field(default_factory=mu.identity)
    color: Optional[np.ndarray] = None
    a: Optional["Pattern"] = None
    b: Optional["Pattern"] = None
    scale: float = 0.0
    octaves: int = 0
    persistence: float = 0.0
    texture: Optional[np.ndarray] = None  # [H, W, 3] float in [0,1]

    @staticmethod
    def solid(color, transform=None):
        return Pattern("solid", transform if transform is not None else mu.identity(),
                       color=np.asarray(color, np.float64))


def default_pattern() -> Pattern:
    return Pattern.solid([1.0, 1.0, 1.0])


@dataclasses.dataclass
class Material:
    """Host material (material.rs:35-58 defaults)."""

    pattern: Pattern = dataclasses.field(default_factory=default_pattern)
    ambient: float = 0.1
    diffuse: float = 0.9
    specular: float = 0.9
    shininess: float = 200.0
    reflective: float = 0.0
    transparency: float = 0.0
    refractive_index: float = 1.0


def glass_material() -> Material:
    """A clear glass material: transparency 1, refractive index 1.5."""
    m = Material()
    m.transparency = 1.0
    m.refractive_index = 1.5
    return m


@dataclasses.dataclass
class Shape:
    """Host scene-graph node; leaves become SoA rows, interior nodes fold."""

    kind: str  # sphere|plane|cube|cylinder|cone|torus|triangle|smooth_triangle|group|csg
    transform: np.ndarray = dataclasses.field(default_factory=mu.identity)
    material: Optional[Material] = None
    hidden: bool = False
    # cylinder / cone
    minimum: float = -np.inf
    maximum: float = np.inf
    closed: bool = False
    # torus
    minor_radius: float = 1.0
    # triangle
    p1: Optional[np.ndarray] = None
    p2: Optional[np.ndarray] = None
    p3: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    n3: Optional[np.ndarray] = None
    # group
    children: Tuple["Shape", ...] = ()
    # csg
    operation: str = "union"
    left: Optional["Shape"] = None
    right: Optional["Shape"] = None


def sphere(transform=None, material=None):
    """A unit sphere leaf (rray_tpu's test constructor)."""
    return Shape("sphere", transform if transform is not None else mu.identity(),
                 material or Material())


def plane(transform=None, material=None):
    """An xz-plane leaf (rray_tpu's test constructor)."""
    return Shape("plane", transform if transform is not None else mu.identity(),
                 material or Material())


@dataclasses.dataclass
class PointLight:
    position: np.ndarray
    intensity: np.ndarray


@dataclasses.dataclass
class AreaLight:
    corner: np.ndarray
    uvec: np.ndarray
    vvec: np.ndarray
    intensity: np.ndarray
    level: int = 5

    @property
    def position(self):
        # Area lights shade from their center (light.rs:41-45).
        return self.corner + 0.5 * self.uvec + 0.5 * self.vvec


# --------------------------------------------------------------------------
# Device-side tables.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PatternData:
    ptype: str
    octaves: int
    inv: Any  # [3,4] pattern-space inverse affine
    color: Any  # [3]
    scale: Any  # scalar
    persistence: Any  # scalar
    texture: Any  # [H,W] int32 packed RGB8, [H,W,3] float, or None
    a: Optional["PatternData"]
    b: Optional["PatternData"]


@dataclasses.dataclass
class LightData:
    kind: str  # "point" | "area"
    level: int
    position: Any  # [3] (area: center)
    intensity: Any  # [3]
    corner: Any  # [3] or None
    uvec: Any
    vvec: Any


# Tensor fields of SceneData, in rray_tpu's SceneData order.
TENSOR_FIELDS = (
    "prim_inv", "prim_nmat", "prim_type", "prim_row",
    "mat_ambient", "mat_diffuse", "mat_specular", "mat_shininess",
    "mat_reflective", "mat_transparency", "mat_ior", "pattern_id",
    "prim_class", "cls_table",
    "sph_inv", "sph_prim", "pla_inv", "pla_prim", "cub_inv", "cub_prim",
    "cyl_inv", "cyl_prim", "cyl_min", "cyl_max", "cyl_closed",
    "con_inv", "con_prim", "con_min", "con_max", "con_closed",
    "tor_inv", "tor_prim", "tor_r",
    "tri_p1", "tri_e1", "tri_e2",
    "tri_n1", "tri_n2", "tri_n3", "tri_smooth", "tri_prim",
    "tri_class", "csg_side",
)
# Structural fields (plain Python), in rray_tpu's SceneData order.
STATIC_FIELDS = (
    "csg_ops", "has_reflective", "has_transparent", "counts", "prim_kinds",
    "prim_rows_static", "csg_member_static", "csg_side_static",
    "n_classes", "prim_class_static", "prim_pattern_static",
)


@dataclasses.dataclass
class SceneData:
    """All device tensors for one compiled scene (leaves may be size 0).

    Field meanings follow rray_tpu's SceneData: per-prim tables indexed
    by prim id (DFS order), per-type analytic tables, world-space
    triangle tables, CSG sides, then the structural Python fields."""

    prim_inv: Any       # [P,3,4] composed world->object affine
    prim_nmat: Any      # [P,3,3] object-normal -> world (unnormalized)
    prim_type: Any      # [P] int32 type code
    prim_row: Any       # [P] int32 row in its per-type table
    mat_ambient: Any    # [P]
    mat_diffuse: Any
    mat_specular: Any
    mat_shininess: Any
    mat_reflective: Any
    mat_transparency: Any
    mat_ior: Any
    pattern_id: Any     # [P] int32 index into `patterns`
    prim_class: Any     # [P] int32 shade-class id (see CLS_* columns)
    cls_table: Any      # [M, CLS_COLS] class shade table
    sph_inv: Any        # [Ns,3,4]
    sph_prim: Any       # [Ns] int32
    pla_inv: Any
    pla_prim: Any
    cub_inv: Any
    cub_prim: Any
    cyl_inv: Any
    cyl_prim: Any
    cyl_min: Any        # [Ncyl]
    cyl_max: Any
    cyl_closed: Any     # [Ncyl] bool
    con_inv: Any
    con_prim: Any
    con_min: Any
    con_max: Any
    con_closed: Any
    tor_inv: Any
    tor_prim: Any
    tor_r: Any          # [Nt] minor radius
    tri_p1: Any         # [T,3]
    tri_e1: Any
    tri_e2: Any
    tri_n1: Any         # [T,3] unnormalized world vertex normals
    tri_n2: Any
    tri_n3: Any
    tri_smooth: Any     # [T] bool
    tri_prim: Any       # [T] int32
    tri_class: Any      # [T] int32
    csg_side: Any       # [C, P] int32
    lights: Tuple[LightData, ...]
    patterns: Tuple[PatternData, ...]
    csg_ops: Tuple[int, ...]
    has_reflective: bool
    has_transparent: bool
    counts: Tuple[int, ...]  # (Ns, Npl, Ncu, Ncy, Nco, Nto, T, P)
    prim_kinds: Tuple[int, ...]
    prim_rows_static: Tuple[int, ...]
    csg_member_static: Tuple[bool, ...] = ()
    csg_side_static: Tuple[Tuple[int, ...], ...] = ()
    n_classes: int = 0
    prim_class_static: Tuple[int, ...] = ()
    prim_pattern_static: Tuple[int, ...] = ()
    # Tables derived from this scene's tensors (the kernels' tables, the
    # canonical scene), built at first use and kept for this object's
    # life (`cached`). Each SceneData starts with an empty cache:
    # `dataclasses.replace` and `merge_scene` hand the new scene none of
    # the old one's tables. The kernels' tables are built from detached
    # tensors; a value autograd must reach through is not kept while
    # some leaf requires grad. Change a scene's tensors through a new
    # SceneData, not in place: the cache does not see in-place writes.
    kernel_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    def cached(self, key, make, grad: bool = False):
        """make(), once per scene under `key`. grad=True marks a value
        built from the live tensors, which autograd reaches through: it
        is made anew at every call while some leaf requires grad."""
        if grad and self.requires_grad():
            return make()
        if key not in self.kernel_cache:
            self.kernel_cache[key] = make()
        return self.kernel_cache[key]

    def requires_grad(self) -> bool:
        """Does some float leaf of the scene require grad?"""
        return any(t.requires_grad for _, t in float_leaves(self))

    @property
    def dtype(self):
        return self.cls_table.dtype

    @property
    def device(self):
        return self.cls_table.device


# --------------------------------------------------------------------------
# Compilation: host scene graph -> SceneData.
# --------------------------------------------------------------------------

_KIND_TO_TYPE = {
    "sphere": SPHERE, "plane": PLANE, "cube": CUBE, "cylinder": CYLINDER,
    "cone": CONE, "torus": TORUS, "triangle": TRIANGLE,
    "smooth_triangle": TRIANGLE,
}


class _CsgNode:
    """One CSG node: its op, depth, the leaf prim ids under each child and
    the leaves the reference's left.includes() reports."""

    def __init__(self, op, depth):
        self.op = op
        self.depth = depth
        self.left_leaves = []
        self.right_leaves = []
        self.left_direct = []


def _walk(shape: Shape, parent_world: np.ndarray, leaves, csgs, depth):
    """DFS fold of the scene graph into leaves (shape, world, material) and
    CSG nodes (rray_tpu scene/data.py _walk). Returns the prim ids added
    in this subtree and the ones `includes()` reports for this node:
    group, recursive (group.rs:151-159); CSG, its direct primitive
    children only (csg.rs:295-297); primitive, itself.

    `hidden` is honored only where the reference's builder consults it:
    top-level objects (scene_builder_yaml.rs:401) and group children
    (scene_builder_yaml.rs:169); a hidden CSG operand is still built."""
    world = parent_world @ shape.transform
    if shape.kind == "group":
        subtree, included = [], []
        for child in shape.children:
            if not child.hidden:
                s, i = _walk(child, world, leaves, csgs, depth + 1)
                subtree += s
                included += i
        return subtree, included
    if shape.kind == "csg":
        node = _CsgNode(_CSG_OPS[shape.operation], depth)
        csgs.append(node)
        ls, li = _walk(shape.left, world, leaves, csgs, depth + 1)
        rs, _ = _walk(shape.right, world, leaves, csgs, depth + 1)
        node.left_leaves, node.right_leaves, node.left_direct = ls, rs, li
        direct = []
        for child, sub in ((shape.left, ls), (shape.right, rs)):
            if child.kind not in ("group", "csg"):
                direct += sub
        return ls + rs, direct
    if shape.kind not in _KIND_TO_TYPE:
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    leaves.append((shape, world, shape.material or Material()))
    return [len(leaves) - 1], [len(leaves) - 1]


def _csg_tables(csgs, P):
    """(csg_ops, [C, P] side table) innermost (deepest) first, a stable
    sort: side 1 for the leaves the node's left.includes() reports, 2 for
    every other leaf under the node (rray_tpu scene/data.py:601-610)."""
    csgs = sorted(csgs, key=lambda c: -c.depth)
    side = np.zeros((len(csgs), max(P, 1)), np.int32)
    for ci, node in enumerate(csgs):
        left = set(node.left_direct)
        for pid in node.left_leaves + node.right_leaves:
            side[ci, pid] = 1 if pid in left else 2
    return tuple(c.op for c in csgs), side


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10-bit ints so bits land every 3 positions (Morton)."""
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def _morton_sort(tri_pids, leaves):
    """Order triangle prim ids along a Morton curve of world centroids
    (rray_tpu scene/data.py _morton_sort: same codes, stable argsort)."""
    if len(tri_pids) < 2:
        return tri_pids
    cents = []
    for pid in tri_pids:
        s, world, _ = leaves[pid]
        A, b = world[:3, :3], world[:3, 3]
        cents.append(np.mean([A @ np.asarray(p) + b
                              for p in (s.p1, s.p2, s.p3)], axis=0))
    cents = np.asarray(cents)
    lo = cents.min(axis=0)
    span = np.maximum(cents.max(axis=0) - lo, 1e-12)
    q = np.clip(((cents - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << np.uint64(1))
            | (_spread_bits(q[:, 2]) << np.uint64(2)))
    return [tri_pids[i] for i in np.argsort(code, kind="stable")]


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _compile_pattern(p: Pattern, dtype, device) -> PatternData:
    tex = None
    if p.texture is not None:
        # 8-bit sources pack RGB into one int32 plane (the value layout
        # of rray_tpu's uint32 packing); others keep float [H,W,3].
        arr = np.asarray(p.texture, np.float64)
        q = np.round(arr * 255.0)
        if (arr.ndim == 3 and arr.shape[-1] == 3
                and q.min() >= 0.0 and q.max() <= 255.0
                and np.abs(arr * 255.0 - q).max() < 1e-9):
            qi = q.astype(np.int32)
            tex = _tensor((qi[..., 0] << 16) | (qi[..., 1] << 8) | qi[..., 2],
                          torch.int32, device)
        else:
            tex = _tensor(arr, dtype, device)
    return PatternData(
        ptype=p.ptype,
        octaves=int(p.octaves),
        inv=_tensor(mu.affine(mu.inverse(p.transform)), dtype, device),
        color=_tensor(p.color if p.color is not None else np.zeros(3),
                      dtype, device),
        scale=_tensor(p.scale, dtype, device),
        persistence=_tensor(p.persistence, dtype, device),
        texture=tex,
        a=_compile_pattern(p.a, dtype, device) if p.a is not None else None,
        b=_compile_pattern(p.b, dtype, device) if p.b is not None else None,
    )


def _compile_light(light, dtype, device) -> LightData:
    t = lambda v: _tensor(v, dtype, device)
    if isinstance(light, PointLight):
        return LightData("point", 0, t(light.position), t(light.intensity),
                         None, None, None)
    return LightData("area", int(light.level), t(light.position),
                     t(light.intensity), t(light.corner), t(light.uvec),
                     t(light.vvec))


def compile_scene(objects, lights, dtype=torch.float32,
                  device="cuda") -> SceneData:
    """Fold a host scene graph into SoA tables on `device` (the card
    unless the caller passes "cpu"; config.checked_device)."""
    with profiling.span("compile"):
        return _compile_scene(objects, lights, dtype, checked_device(device))


def _compile_scene(objects, lights, dtype, device) -> SceneData:
    leaves, csgs = [], []
    for obj in objects:
        if not obj.hidden:
            _walk(obj, mu.identity(), leaves, csgs, 0)
    P = len(leaves)
    csg_ops, csg_side = _csg_tables(csgs, P)

    # Deduplicate pattern roots by host-object identity (OBJ meshes share
    # one material across thousands of triangles).
    pattern_roots: list[Pattern] = []
    pattern_index: dict[int, int] = {}

    def pattern_id_of(p: Pattern) -> int:
        if id(p) not in pattern_index:
            pattern_index[id(p)] = len(pattern_roots)
            pattern_roots.append(p)
        return pattern_index[id(p)]

    prim_inv = np.zeros((P, 3, 4))
    prim_nmat = np.zeros((P, 3, 3))
    prim_type = np.zeros(P, np.int32)
    prim_row = np.zeros(P, np.int32)
    mats = {k: np.zeros(P) for k in
            ("ambient", "diffuse", "specular", "shininess", "reflective",
             "transparency", "ior")}
    pat_ids = np.zeros(P, np.int32)
    by_type: dict[int, list[int]] = {t: [] for t in range(7)}
    for pid, (shape, world, m) in enumerate(leaves):
        t = _KIND_TO_TYPE[shape.kind]
        prim_type[pid] = t
        prim_row[pid] = len(by_type[t])
        by_type[t].append(pid)
        prim_inv[pid] = mu.affine(mu.inverse(world))
        prim_nmat[pid] = mu.normal_matrix(world)
        mats["ambient"][pid] = m.ambient
        mats["diffuse"][pid] = m.diffuse
        mats["specular"][pid] = m.specular
        mats["shininess"][pid] = m.shininess
        mats["reflective"][pid] = m.reflective
        mats["transparency"][pid] = m.transparency
        mats["ior"][pid] = m.refractive_index
        pat_ids[pid] = pattern_id_of(m.pattern)

    f = lambda x: _tensor(x, dtype, device)
    i32 = lambda x: _tensor(np.asarray(x, np.int32), torch.int32, device)
    tables = {}
    for name, t in (("sph", SPHERE), ("pla", PLANE), ("cub", CUBE),
                    ("cyl", CYLINDER), ("con", CONE), ("tor", TORUS)):
        ids = by_type[t]
        tables[f"{name}_inv"] = f(prim_inv[ids] if ids else np.zeros((0, 3, 4)))
        tables[f"{name}_prim"] = i32(ids)
    for name, t in (("cyl", CYLINDER), ("con", CONE)):
        shapes = [leaves[p][0] for p in by_type[t]]
        tables[f"{name}_min"] = f([s.minimum for s in shapes])
        tables[f"{name}_max"] = f([s.maximum for s in shapes])
        tables[f"{name}_closed"] = _tensor(
            np.array([s.closed for s in shapes], bool), torch.bool, device)
    tables["tor_r"] = f([leaves[p][0].minor_radius for p in by_type[TORUS]])

    # Triangles: world-space vertices (t/u/v are invariant under the
    # fold); vertex normals ride the normal matrix unnormalized, so the
    # smooth interpolation (smooth_triangle.rs:99-101) stays exact. Flat
    # triangles store n1 = n2 = n3 = their unit normal e2 x e1
    # (triangle.rs:55). Rows follow the Morton order of world centroids.
    tris = _morton_sort(by_type[TRIANGLE], leaves)
    T = len(tris)
    tri = {k: np.zeros((T, 3)) for k in ("p1", "e1", "e2", "n1", "n2", "n3")}
    tri_smooth = np.zeros(T, bool)
    for row, pid in enumerate(tris):
        prim_row[pid] = row
        s, world, _ = leaves[pid]
        A, b = world[:3, :3], world[:3, 3]
        p1w, p2w, p3w = (A @ np.asarray(p) + b for p in (s.p1, s.p2, s.p3))
        e1, e2 = p2w - p1w, p3w - p1w
        tri["p1"][row], tri["e1"][row], tri["e2"][row] = p1w, e1, e2
        if s.kind == "smooth_triangle":
            tri_smooth[row] = True
            for k, n in (("n1", s.n1), ("n2", s.n2), ("n3", s.n3)):
                tri[k][row] = prim_nmat[pid] @ np.asarray(n)
        else:
            n = np.cross(e2, e1)
            norm = np.linalg.norm(n)
            n = n / norm if norm > 0 else n
            tri["n1"][row] = tri["n2"][row] = tri["n3"][row] = n

    # Shade classes: each analytic leaf is its own class; a mesh's
    # triangles (same material object and composed transform) collapse
    # to one.
    prim_class = np.zeros(P, np.int32)
    class_index: dict = {}
    class_rep: list[int] = []
    for pid, (shape, world, m) in enumerate(leaves):
        key = (("tri", id(m), world.tobytes())
               if prim_type[pid] == TRIANGLE else ("leaf", pid))
        if key not in class_index:
            class_index[key] = len(class_rep)
            class_rep.append(pid)
        prim_class[pid] = class_index[key]
    M = len(class_rep)
    cls_table = np.zeros((max(M, 1), CLS_COLS))
    for ci, pid in enumerate(class_rep):
        shape, _, m = leaves[pid]
        row = cls_table[ci]
        row[CLS_INV:CLS_INV + 12] = prim_inv[pid].reshape(12)
        row[CLS_NMAT:CLS_NMAT + 9] = prim_nmat[pid].reshape(9)
        row[CLS_TYPE] = prim_type[pid]
        row[CLS_PATTERN] = pat_ids[pid]
        row[CLS_AMBIENT] = m.ambient
        row[CLS_DIFFUSE] = m.diffuse
        row[CLS_SPECULAR] = m.specular
        row[CLS_SHININESS] = m.shininess
        row[CLS_REFLECTIVE] = m.reflective
        row[CLS_TRANSPARENCY] = m.transparency
        row[CLS_IOR] = m.refractive_index
        if shape.kind in ("cylinder", "cone"):
            row[CLS_PMIN] = shape.minimum
            row[CLS_PMAX] = shape.maximum
            row[CLS_CLOSED] = float(bool(shape.closed))
        elif shape.kind == "torus":
            row[CLS_TORR] = shape.minor_radius

    materials = [m for _, _, m in leaves]
    return SceneData(
        prim_inv=f(prim_inv), prim_nmat=f(prim_nmat),
        prim_type=i32(prim_type), prim_row=i32(prim_row),
        mat_ambient=f(mats["ambient"]), mat_diffuse=f(mats["diffuse"]),
        mat_specular=f(mats["specular"]),
        mat_shininess=f(mats["shininess"]),
        mat_reflective=f(mats["reflective"]),
        mat_transparency=f(mats["transparency"]), mat_ior=f(mats["ior"]),
        pattern_id=i32(pat_ids), prim_class=i32(prim_class),
        cls_table=f(cls_table),
        **tables,
        **{f"tri_{k}": f(v) for k, v in tri.items()},
        tri_smooth=_tensor(tri_smooth, torch.bool, device),
        tri_prim=i32(tris), tri_class=i32(prim_class[tris]),
        csg_side=i32(csg_side),
        lights=tuple(_compile_light(l, dtype, device) for l in lights),
        patterns=tuple(_compile_pattern(p, dtype, device)
                       for p in pattern_roots),
        csg_ops=csg_ops,
        has_reflective=any(m.reflective > 0.0 for m in materials),
        has_transparent=any(m.transparency > 0.0 for m in materials),
        counts=tuple(len(by_type[t]) for t in range(7)) + (P,),
        prim_kinds=tuple(int(t) for t in prim_type),
        prim_rows_static=tuple(int(r) for r in prim_row),
        csg_member_static=tuple(bool(csg_side[:, p].any()) if csg_ops
                                else False for p in range(P)),
        csg_side_static=tuple(tuple(int(v) for v in row) for row in csg_side),
        n_classes=M,
        prim_class_static=tuple(int(c) for c in prim_class),
        prim_pattern_static=tuple(int(i) for i in pat_ids),
    )


# --------------------------------------------------------------------------
# Leaves by key path, and the canonical scene.
# --------------------------------------------------------------------------

_PATTERN_TENSORS = ("inv", "color", "scale", "persistence", "texture")
_LIGHT_TENSORS = ("position", "intensity", "corner", "uvec", "vvec")


def _pattern_leaves(p: PatternData, prefix: str):
    for name in _PATTERN_TENSORS:
        if getattr(p, name) is not None:
            yield f"{prefix}.{name}", getattr(p, name)
    for name in ("a", "b"):
        if getattr(p, name) is not None:
            yield from _pattern_leaves(getattr(p, name), f"{prefix}.{name}")


def tensor_leaves(scene: SceneData):
    """(key path, tensor) of every tensor of the scene in rray_tpu's
    pytree order, keyed as `jax.tree_util.keystr` keys rray_tpu's
    SceneData (".prim_inv", ".lights[0].intensity",
    ".patterns[0].a.color"); absent (None) leaves are left out, as
    rray_tpu's flatten leaves them out."""
    for name in TENSOR_FIELDS:
        yield f".{name}", getattr(scene, name)
    for i, light in enumerate(scene.lights):
        for name in _LIGHT_TENSORS:
            if getattr(light, name) is not None:
                yield f".lights[{i}].{name}", getattr(light, name)
    for i, p in enumerate(scene.patterns):
        yield from _pattern_leaves(p, f".patterns[{i}]")


def float_leaves(scene: SceneData):
    """The floating-point entries of `tensor_leaves`: the leaves that
    rray_tpu's partition_scene makes parameters."""
    return [(k, t) for k, t in tensor_leaves(scene)
            if torch.is_floating_point(t)]


def replace_leaves(scene: SceneData, new: dict) -> SceneData:
    """The scene with the tensors of `new` (key path -> tensor, keyed as
    `tensor_leaves` keys them) in place of its own."""
    def pick(prefix, names):
        return {n: new[f"{prefix}.{n}"] for n in names
                if f"{prefix}.{n}" in new}

    def pattern(p, prefix):
        if p is None:
            return None
        return dataclasses.replace(
            p, **pick(prefix, _PATTERN_TENSORS),
            a=pattern(p.a, f"{prefix}.a"), b=pattern(p.b, f"{prefix}.b"))

    return dataclasses.replace(
        scene, **pick("", TENSOR_FIELDS),
        lights=tuple(dataclasses.replace(l, **pick(f".lights[{i}]",
                                                   _LIGHT_TENSORS))
                     for i, l in enumerate(scene.lights)),
        patterns=tuple(pattern(p, f".patterns[{i}]")
                       for i, p in enumerate(scene.patterns)))


def canonicalize(scene: SceneData) -> SceneData:
    """The scene with every duplicated tensor re-derived from its
    canonical source (rray_tpu scene/data.py canonicalize).

    The per-type affines (`sph_inv`..`tor_inv`) copy rows of `prim_inv`,
    and the class table (`cls_table`) copies `prim_inv`, `prim_nmat`, the
    `mat_*` scalars and the cylinder/cone/torus extras. Gathers, reshapes
    and casts rebuild them, with no arithmetic, so the values are bit
    for bit those of compile_scene, and gradient mass lands only on the
    canonical leaves (`prim_inv`, `prim_nmat`, `mat_*`, `cyl_*`/`con_*`/
    `tor_r`, `tri_*`, lights, patterns) on every route. render() calls
    it first. While no tensor requires grad it is made once per scene
    (`SceneData.cached`)."""
    return scene.cached("canonical", lambda: _canonicalize(scene), grad=True)


def _canonicalize(scene: SceneData) -> SceneData:
    if not scene.prim_kinds:
        return scene
    dtype, device = scene.prim_inv.dtype, scene.prim_inv.device
    kinds = scene.prim_kinds
    upd: dict = {}
    for name, t in (("sph_inv", SPHERE), ("pla_inv", PLANE),
                    ("cub_inv", CUBE), ("cyl_inv", CYLINDER),
                    ("con_inv", CONE), ("tor_inv", TORUS)):
        ids = [i for i, k in enumerate(kinds) if k == t]
        if ids:
            upd[name] = scene.prim_inv[torch.tensor(ids, device=device)]

    M = scene.n_classes
    if M:
        reps: list = [None] * M
        for pid, ci in enumerate(scene.prim_class_static):
            if reps[ci] is None:
                reps[ci] = pid
        z = torch.zeros(1, dtype=dtype, device=device)
        const = lambda v: torch.full((1,), float(v), dtype=dtype,
                                     device=device)
        rows = []
        for pid in reps:
            t = kinds[pid]
            row = scene.prim_rows_static[pid]
            pmin = pmax = closed = torr = z
            if t in (CYLINDER, CONE):
                lo, hi, cl = ((scene.cyl_min, scene.cyl_max, scene.cyl_closed)
                              if t == CYLINDER else
                              (scene.con_min, scene.con_max, scene.con_closed))
                pmin, pmax = lo[row:row + 1], hi[row:row + 1]
                closed = cl[row:row + 1].to(dtype)
            elif t == TORUS:
                torr = scene.tor_r[row:row + 1]
            rows.append(torch.cat([
                scene.prim_inv[pid].reshape(-1),
                scene.prim_nmat[pid].reshape(-1),
                const(t), const(scene.prim_pattern_static[pid]),
                *(getattr(scene, f"mat_{m}")[pid:pid + 1] for m in (
                    "ambient", "diffuse", "specular", "shininess",
                    "reflective", "transparency", "ior")),
                pmin, pmax, closed, torr]))
        upd["cls_table"] = torch.stack(rows)
    return dataclasses.replace(scene, **upd)


def analytic_slot_count(scene: SceneData) -> int:
    """Hit slots of the scene's analytic prims per ray (SLOTS_PER_TYPE)."""
    ns, npl, ncu, ncy, nco, nto, _, _ = scene.counts
    return (SLOTS_PER_TYPE[SPHERE] * ns + SLOTS_PER_TYPE[PLANE] * npl
            + SLOTS_PER_TYPE[CUBE] * ncu + SLOTS_PER_TYPE[CYLINDER] * ncy
            + SLOTS_PER_TYPE[CONE] * nco + SLOTS_PER_TYPE[TORUS] * nto)
