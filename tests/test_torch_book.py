"""The book's facts ("The Ray Tracer Challenge": the reference's inline
tests, which tests/test_core.py and tests/test_shapes.py assert through
rray_tpu's per-ray helpers) through the port's per-ray path, in float64.

Each case builds its scene twice, from each package's own host classes
and compile_scene, runs the same query through the port
(ops/hits.gather_sorted_hits, ops/normals.normal_at, color_at and
color_at_aos, render/camera.rays_for_pixels, hits.refractive_indices)
and through rray_tpu's helper of the same name, and asserts the book's
value (at the book's precision) and equality with rray_tpu at 1e-9."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu
import rray_tpu_torch as rt
from rray_tpu import mathutils as jmu
from rray_tpu.ops import hits as jhits
from rray_tpu.ops import normals as jnrm
from rray_tpu.render import camera as jcam
from rray_tpu.render import integrator as jint
from rray_tpu_torch import mathutils as tmu
from rray_tpu_torch.ops import hits as thits
from rray_tpu_torch.ops import normals as tnrm
from rray_tpu_torch.render import camera as tcam
from rray_tpu_torch.render import integrator as tint

ATOL = 1e-9
JAX = types.SimpleNamespace(
    Shape=rray_tpu.Shape, Material=rray_tpu.Material,
    Pattern=rray_tpu.Pattern, PointLight=rray_tpu.PointLight, mu=jmu,
    compile=lambda objs, lights: rray_tpu.compile_scene(
        objs, lights, dtype=jnp.float64))
PORT = types.SimpleNamespace(
    Shape=rt.Shape, Material=rt.Material, Pattern=rt.Pattern,
    PointLight=rt.PointLight, mu=tmu,
    compile=lambda objs, lights: rt.compile_scene(
        objs, lights, dtype=torch.float64, device="cpu"))
JSET = rray_tpu.RenderSettings()
TSET = rt.RenderSettings()
R2 = np.sqrt(2.0) / 2


@functools.lru_cache(maxsize=None)
def scenes(build):
    """(rray_tpu SceneData, the port's SceneData) of build(package)."""
    return JAX.compile(*build(JAX)), PORT.compile(*build(PORT))


def rays(origin, direction):
    """One ray as ([1, 3] jax arrays, [1, 3] torch tensors)."""
    o = np.asarray([origin], np.float64)
    d = np.asarray([direction], np.float64)
    return (jnp.asarray(o), jnp.asarray(d)), (torch.from_numpy(o),
                                              torch.from_numpy(d))


def norm(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).tolist()


def light(m, pos=(0.0, 0.0, 0.0)):
    return m.PointLight(np.array(pos, np.float64), np.ones(3))


# --- scenes, each a function of the package namespace -> (objects, lights)

def default_world(m):
    """Scene::default_scene (scene.rs:79-92)."""
    s1 = m.Shape("sphere", material=m.Material(
        pattern=m.Pattern.solid([0.8, 1.0, 0.6]), diffuse=0.7, specular=0.2))
    s2 = m.Shape("sphere", transform=m.mu.scale(0.5, 0.5, 0.5),
                 material=m.Material())
    return [s1, s2], [light(m, (-10.0, 10.0, -10.0))]


def one(kind, transform=None, **kw):
    def build(m):
        t = m.mu.identity() if transform is None else transform(m.mu)
        return [m.Shape(kind, transform=t, material=m.Material(), **kw)], \
            [light(m)]
    build.__name__ = f"{kind}_{sorted(kw.items())}"
    return build


SPHERE = one("sphere")
PLANE = one("plane")
CUBE = one("cube")
CYLINDER = one("cylinder")
TORUS = one("torus", minor_radius=0.25)


def _tri_points():
    return dict(p1=np.array([0.0, 1.0, 0.0]), p2=np.array([-1.0, 0.0, 0.0]),
                p3=np.array([1.0, 0.0, 0.0]))


def triangle(m):
    return [m.Shape("triangle", material=m.Material(), **_tri_points())], \
        [light(m)]


def smooth_triangle(m):
    return [m.Shape("smooth_triangle", material=m.Material(),
                    n1=np.array([0.0, 1.0, 0.0]), n2=np.array([-1.0, 0.0, 0.0]),
                    n3=np.array([1.0, 0.0, 0.0]), **_tri_points())], [light(m)]


def group_of_three(m):
    kids = (m.Shape("sphere"), m.Shape("sphere", m.mu.translate(0, 0, -3)),
            m.Shape("sphere", m.mu.translate(5, 0, 0)))
    return [m.Shape("group", children=kids)], [light(m)]


def scaled_group(m):
    return [m.Shape("group", transform=m.mu.scale(2, 2, 2), children=(
        m.Shape("sphere", transform=m.mu.translate(5, 0, 0)),))], [light(m)]


def hidden_child(m):
    kids = (m.Shape("sphere"),
            m.Shape("sphere", m.mu.translate(0, 0, -3), hidden=True))
    return [m.Shape("group", children=kids)], [light(m)]


def group_chain(m):
    inner = m.Shape("group", transform=m.mu.scale(1, 2, 3), children=(
        m.Shape("sphere", transform=m.mu.translate(5, 0, 0)),))
    return [m.Shape("group", transform=m.mu.rotate_y(np.pi / 2),
                    children=(inner,))], [light(m)]


def csg(op):
    def build(m):
        return [m.Shape("csg", operation=op, left=m.Shape("sphere"),
                        right=m.Shape("sphere", m.mu.translate(0, 0, 0.5)))], \
            [light(m)]
    build.__name__ = f"csg_{op}"
    return build


def cube_minus_ball(m):
    return [m.Shape("csg", operation="difference", left=m.Shape("cube"),
                    right=m.Shape("sphere", m.mu.scale(1.2, 1.2, 1.2)))], \
        [light(m)]


def nested_csg(m):
    inner = m.Shape("csg", operation="union",
                    left=m.Shape("sphere", m.mu.translate(0, 0, 0.5)),
                    right=m.Shape("sphere", m.mu.translate(0, 0, -0.5)))
    return [m.Shape("csg", operation="difference",
                    left=m.Shape("sphere", m.mu.scale(2, 2, 2)),
                    right=inner)], [light(m)]


def glass_spheres(m):
    """ray.rs:256-296: three overlapping glass spheres."""
    def glass(t, ior):
        return m.Shape("sphere", transform=t, material=m.Material(
            transparency=1.0, refractive_index=ior))
    return [glass(m.mu.scale(2, 2, 2), 1.5),
            glass(m.mu.translate(0, 0, -0.25), 2.0),
            glass(m.mu.translate(0, 0, 0.25), 2.5)], [light(m)]


def nested_glass(m):
    """Five nested glass spheres (deeper than containers_depth=2)."""
    return [m.Shape("sphere", transform=m.mu.scale(s, s, s),
                    material=m.Material(transparency=1.0,
                                        refractive_index=ior))
            for s, ior in zip([5, 4, 3, 2, 1], [1.1, 1.2, 1.3, 1.4, 1.5])], \
        [light(m)]


# --- sorted hit lists: (scene, origin, direction, book: t values or a count)

INTERSECTIONS = {
    "world": (default_world, [0, 0, -5], [0, 0, 1], [4.0, 4.5, 5.5, 6.0]),
    "sphere_tangent": (SPHERE, [0, 1, -5], [0, 0, 1], [5.0, 5.0]),
    "sphere_miss": (SPHERE, [0, 2, -5], [0, 0, 1], []),
    "sphere_inside": (SPHERE, [0, 0, 0], [0, 0, 1], [-1.0, 1.0]),
    "sphere_behind": (SPHERE, [0, 0, 5], [0, 0, 1], [-6.0, -4.0]),
    "sphere_scaled": (one("sphere", lambda mu: mu.scale(2, 2, 2)),
                      [0, 0, -5], [0, 0, 1], [3.0, 7.0]),
    "sphere_translated": (one("sphere", lambda mu: mu.translate(5, 0, 0)),
                          [0, 0, -5], [0, 0, 1], []),
    "plane_above": (PLANE, [0, 1, 0], [0, -1, 0], [1.0]),
    "plane_below": (PLANE, [0, -1, 0], [0, 1, 0], [1.0]),
    "plane_parallel": (PLANE, [0, 10, 0], [0, 0, 1], []),
    "plane_coplanar": (PLANE, [0, 0, 0], [0, 0, 1], []),
    "cylinder_tangent": (CYLINDER, [1, 0, -5], [0, 0, 1], [5.0, 5.0]),
    "cylinder_centre": (CYLINDER, [0, 0, -5], [0, 0, 1], [4.0, 6.0]),
    "cylinder_skew": (CYLINDER, [0.5, 0, -5], norm([0.1, 1, 1]),
                      [6.80798, 7.08872]),
    "cone_axis": (one("cone"), [0, 0, -5], [0, 0, 1], [5.0, 5.0]),
    "cone_diagonal": (one("cone"), [0, 0, -5], norm([1, 1, 1]),
                      [8.66025, 8.66025]),
    "cone_skew": (one("cone"), [1, 1, -5], norm([-0.5, -1, 1]),
                  [4.55006, 49.44994]),
    "cone_parallel_to_half": (one("cone"), [0, 0, -1], norm([0, 1, 1]),
                              [0.35355]),
    "torus_along_x": (TORUS, [-5, 0, 0], [1, 0, 0],
                      [3.75, 4.25, 5.75, 6.25]),
    "torus_through_tube": (TORUS, [1, 0, -5], [0, 0, 1], [4.75, 5.25]),
    "torus_through_hole": (TORUS, [0, 0, -5], [0, 0, 1], []),
    # torus.rs:62-90 keeps only t > 0: from inside the tube.
    "torus_only_positive": (TORUS, [1, 0, 0], [0, 0, 1], [0.25]),
    "triangle_hit": (triangle, [0, 0.5, -2], [0, 0, 1], [2.0]),
    "group_sorted": (group_of_three, [0, 0, -5], [0, 0, 1],
                     [1.0, 3.0, 4.0, 6.0]),
    "group_transformed": (scaled_group, [10, 0, -10], [0, 0, 1], 2),
    "group_hidden_child": (hidden_child, [0, 0, -5], [0, 0, 1], [4.0, 6.0]),
    # csg.rs local_intersect: the filter keeps s1's entry and s2's exit.
    "csg_union": (csg("union"), [0, 0, -5], [0, 0, 1], [4.0, 6.5]),
    "csg_intersection": (csg("intersection"), [0, 0, -5], [0, 0, 1],
                         [4.5, 6.0]),
    "csg_difference": (csg("difference"), [0, 0, -5], [0, 0, 1], [4.0, 4.5]),
    "csg_miss": (csg("union"), [0, 2, -5], [0, 0, 1], []),
    "csg_cube_minus_ball_face": (cube_minus_ball, [0, 0, -5], [0, 0, 1], []),
    "csg_cube_minus_ball_corner": (cube_minus_ball, [0.95, 0.95, -5],
                                   [0, 0, 1], 2),
    # The big sphere spans [3, 7]; the inner union spans [3.5, 6.5].
    "csg_nested": (nested_csg, [0, 0, -5], [0, 0, 1], [3.0, 3.5, 6.5, 7.0]),
}
for _i, (_o, _d, _t1, _t2) in enumerate([
        ([5, 0.5, 0], [-1, 0, 0], 4, 6), ([-5, 0.5, 0], [1, 0, 0], 4, 6),
        ([0.5, 5, 0], [0, -1, 0], 4, 6), ([0.5, -5, 0], [0, 1, 0], 4, 6),
        ([0.5, 0, 5], [0, 0, -1], 4, 6), ([0.5, 0, -5], [0, 0, 1], 4, 6),
        ([0, 0.5, 0], [0, 0, 1], -1, 1)]):
    INTERSECTIONS[f"cube_hit{_i}"] = (CUBE, _o, _d, [float(_t1), float(_t2)])
for _i, (_o, _d) in enumerate([
        ([-2, 0, 0], [0.2673, 0.5345, 0.8018]),
        ([0, -2, 0], [0.8018, 0.2673, 0.5345]),
        ([0, 0, -2], [0.5345, 0.8018, 0.2673]), ([2, 0, 2], [0, 0, -1]),
        ([0, 2, 2], [0, -1, 0]), ([2, 2, 0], [-1, 0, 0])]):
    INTERSECTIONS[f"cube_miss{_i}"] = (CUBE, _o, _d, [])
for _i, (_o, _d) in enumerate([([1, 0, 0], [0, 1, 0]), ([0, 0, 0], [0, 1, 0]),
                               ([0, 0, -5], [1, 1, 1])]):
    INTERSECTIONS[f"cylinder_miss{_i}"] = (CYLINDER, _o, norm(_d), [])
for _i, (_o, _d, _n) in enumerate([
        ([0, 1.5, 0], [0.1, 1, 0], 0), ([0, 3, -5], [0, 0, 1], 0),
        ([0, 0, -5], [0, 0, 1], 0), ([0, 2, -5], [0, 0, 1], 0),
        ([0, 1, -5], [0, 0, 1], 0), ([0, 1.5, -2], [0, 0, 1], 2)]):
    INTERSECTIONS[f"cylinder_truncated{_i}"] = (
        one("cylinder", minimum=1.0, maximum=2.0), _o, norm(_d), _n)
for _i, (_o, _d) in enumerate([([0, 3, 0], [0, -1, 0]),
                               ([0, 3, -2], [0, -1, 2]),
                               ([0, 4, -2], [0, -1, 1]),
                               ([0, 0, -2], [0, 1, 2]),
                               ([0, -1, -2], [0, 1, 1])]):
    INTERSECTIONS[f"cylinder_capped{_i}"] = (
        one("cylinder", minimum=1.0, maximum=2.0, closed=True), _o, norm(_d),
        2)
# The book expects 2 hits for the second ray; the reference's linear
# early return (cone.rs:134-141) skips the caps -> 1, as rray_tpu has it.
for _i, (_o, _d, _n) in enumerate([([0, 0, -5], [0, 1, 0], 0),
                                   ([0, 0, -0.25], [0, 1, 1], 1),
                                   ([0, 0, -0.25], [0, 1, 0], 4)]):
    INTERSECTIONS[f"cone_capped{_i}"] = (
        one("cone", minimum=-0.5, maximum=0.5, closed=True), _o, norm(_d), _n)
for _i, _o in enumerate([[0, -1, -2], [1, 1, -2], [-1, 1, -2]]):
    INTERSECTIONS[f"triangle_miss{_i}"] = (
        triangle, _o, [0, 1, 0] if _i == 0 else [0, 0, 1], [])
INTERSECTIONS["triangle_miss3"] = (triangle, [0, -1, -2], [0, 0, 1], [])


def both_slots(build, origin, direction, settings=(JSET, TSET)):
    (jo, jd), (to, td) = rays(origin, direction)
    js, ts = scenes(build)
    return (jhits.gather_sorted_hits(js, jo, jd, settings[0]),
            thits.gather_sorted_hits(ts, to, td, settings[1]), js, ts)


def kept(slots):
    t = np.asarray(slots.t[0])[np.asarray(slots.valid[0])]
    return t[np.isfinite(t)]


@pytest.mark.parametrize("case", sorted(INTERSECTIONS))
def test_sorted_hits(case):
    """The filtered, sorted hit list: the book's t values (1e-5 where the
    book prints five places, else 1e-6) or hit count, and rray_tpu's
    slots (t, prim, validity) at 1e-9."""
    build, origin, direction, book = INTERSECTIONS[case]
    want, got, _, _ = both_slots(build, origin, direction)
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    ts = kept(got)
    if isinstance(book, int):
        assert ts.size == book, ts
    else:
        np.testing.assert_allclose(ts, book, atol=1e-5 if any(
            round(b, 2) != b for b in book) else 1e-6)


def test_hit_selection():
    """intersection.rs hit(): the lowest t >= 0; none from behind."""
    for origin, found, t in (([0, 0, 0], True, 1.0), ([0, 0, 5], False, None)):
        want, got, _, _ = both_slots(SPHERE, origin, [0, 0, 1])
        sel_t = thits.select_hit(got)
        sel_j = jhits.select_hit(want)
        for a, b in zip(sel_t, sel_j):
            np.testing.assert_allclose(a.numpy().astype(np.float64),
                                       np.asarray(b).astype(np.float64),
                                       atol=ATOL)
        assert bool(sel_t[0][0]) == found
        if found:
            assert abs(float(sel_t[2][0]) - t) < 1e-12


def test_smooth_triangle_uv_and_normal():
    """smooth_triangle.rs:280-317: u = 0.45, v = 0.25 and the normal
    interpolated from the vertex normals."""
    want, got, js, ts = both_slots(smooth_triangle, [-0.2, 0.3, -2.0],
                                   [0, 0, 1])
    found, _, t, prim, u, v = thits.select_hit(got)
    assert bool(found[0])
    assert abs(float(u[0]) - 0.45) < 1e-9 and abs(float(v[0]) - 0.25) < 1e-9
    jfound, _, jt, jprim, ju, jv = jhits.select_hit(want)
    np.testing.assert_allclose([float(t[0]), float(u[0]), float(v[0])],
                               [float(jt[0]), float(ju[0]), float(jv[0])],
                               atol=ATOL)
    pt = [[-0.2, 0.3, -2.0]]
    n = tnrm.normal_at(ts, prim, u, v, torch.tensor(pt, dtype=torch.float64))
    jn = jnrm.normal_at(js, jprim, ju, jv, jnp.asarray(pt, jnp.float64))
    np.testing.assert_allclose(n.numpy()[0], [-0.5547, 0.83205, 0], atol=1e-5)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=ATOL)


# --- normals: (scene, world point, book normal, tolerance)

NORMALS = {
    "sphere_x": (SPHERE, [1, 0, 0], [1, 0, 0], 1e-12),
    "sphere_nonaxial": (SPHERE, [np.sqrt(3) / 3] * 3, [np.sqrt(3) / 3] * 3,
                        1e-12),
    "sphere_translated": (one("sphere", lambda mu: mu.translate(0, 1, 0)),
                          [0, 1.70711, -0.70711], [0, 0.70711, -0.70711],
                          1e-5),
    "sphere_transformed": (one("sphere", lambda mu: mu.scale(1, 0.5, 1)
                               @ mu.rotate_z(np.pi / 5)),
                           [0, R2, -R2], [0, 0.97014, -0.24254], 1e-5),
    "cone_side": (one("cone"), [1, 1, 1], norm([1, -np.sqrt(2.0), 1]), 1e-9),
    "cone_below": (one("cone"), [-1, -1, 0], norm([-1, 1, 0]), 1e-9),
    "torus_outer": (TORUS, [1.25, 0, 0], [1, 0, 0], 1e-6),
    "torus_top": (TORUS, [1, 0, 0.25], [0, 0, 1], 1e-6),
    # object.rs:129-138 through the folded group chain.
    "group_chain": (group_chain, [1.7321, 1.1547, -5.5774],
                    [0.2857, 0.4286, -0.8571], 1e-4),
}
for _i, (_p, _n) in enumerate([
        ([1, 0.5, -0.8], [1, 0, 0]), ([-1, -0.2, 0.9], [-1, 0, 0]),
        ([-0.4, 1, -0.1], [0, 1, 0]), ([0.3, -1, -0.7], [0, -1, 0]),
        ([-0.6, 0.3, 1], [0, 0, 1]),
        # Ties go to x: local_normal_at checks x first (cube.rs:79-88).
        ([0.4, 0.4, -0.4], [1, 0, 0]), ([1, 1, 1], [1, 0, 0]),
        ([-1, -1, -1], [-1, 0, 0])]):
    NORMALS[f"cube{_i}"] = (CUBE, _p, _n, 1e-9)
for _i, (_p, _n) in enumerate([([1, 0, 0], [1, 0, 0]), ([0, 5, -1], [0, 0, -1]),
                               ([0, -2, 1], [0, 0, 1]),
                               ([-1, 1, 0], [-1, 0, 0])]):
    NORMALS[f"cylinder{_i}"] = (CYLINDER, _p, _n, 1e-9)
for _i, (_p, _n) in enumerate([([0, 1, 0], [0, -1, 0]),
                               ([0.5, 1, 0], [0, -1, 0]),
                               ([0, 1, 0.5], [0, -1, 0]),
                               ([0, 2, 0], [0, 1, 0]), ([0.5, 2, 0], [0, 1, 0]),
                               ([0, 2, 0.5], [0, 1, 0])]):
    NORMALS[f"cylinder_cap{_i}"] = (
        one("cylinder", minimum=1.0, maximum=2.0, closed=True), _p, _n, 1e-9)


@pytest.mark.parametrize("case", sorted(NORMALS))
def test_normal_at(case):
    """The world normal at a point of prim 0: the book's value and
    rray_tpu's normal_at at 1e-9."""
    build, point, book, tol = NORMALS[case]
    js, ts = scenes(build)
    pt = np.asarray([point], np.float64)
    got = tnrm.normal_at(ts, torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.float64),
                         torch.zeros(1, dtype=torch.float64),
                         torch.from_numpy(pt)).numpy()
    want = np.asarray(jnrm.normal_at(js, jnp.asarray([0]),
                                     jnp.zeros(1, jnp.float64),
                                     jnp.zeros(1, jnp.float64),
                                     jnp.asarray(pt)))
    np.testing.assert_allclose(got[0], book, atol=tol)
    np.testing.assert_allclose(got, want, atol=ATOL)


# --- colours: (scene, origin, direction, remaining, book colour, tolerance)

def inside_world(m):
    s1, s2 = default_world(m)[0]
    return [s1, s2], [light(m, (0.0, 0.25, 0.0))]


def ambient_world(m):
    s1 = m.Shape("sphere", material=m.Material(
        pattern=m.Pattern.solid([0.8, 1.0, 0.6]), diffuse=0.7, specular=0.2,
        ambient=1.0))
    s2 = m.Shape("sphere", transform=m.mu.scale(0.5, 0.5, 0.5),
                 material=m.Material(ambient=1.0))
    return [s1, s2], [light(m, (-10.0, 10.0, -10.0))]


def shadow_world(m):
    return [m.Shape("sphere", material=m.Material()),
            m.Shape("sphere", transform=m.mu.translate(0, 0, 10),
                    material=m.Material())], [light(m, (0.0, 0.0, -10.0))]


def floor_world(m):
    s1 = m.Shape("sphere", material=m.Material(
        pattern=m.Pattern.solid([0.8, 1.0, 0.6]), diffuse=0.7, specular=0.2))
    s2 = m.Shape("sphere", transform=m.mu.scale(0.5, 0.5, 0.5),
                 material=m.Material(ambient=1.0))
    s3 = m.Shape("plane", transform=m.mu.translate(0, -1, 0),
                 material=m.Material(reflective=0.5))
    return [s1, s2, s3], [light(m, (-10.0, 10.0, -10.0))]


def mirrors(m):
    return [m.Shape("plane", transform=m.mu.translate(0, -1, 0),
                    material=m.Material(reflective=1.0)),
            m.Shape("plane", transform=m.mu.translate(0, 1, 0),
                    material=m.Material(reflective=1.0))], [light(m)]


def glass_floor(reflective):
    def build(m):
        # s1 carries Pattern::test() (colour = point, scene.rs:766,804).
        s1 = m.Shape("sphere", material=m.Material(
            pattern=m.Pattern("test"), diffuse=0.7, specular=0.2))
        s2 = m.Shape("sphere", transform=m.mu.scale(0.5, 0.5, 0.5),
                     material=m.Material())
        floor = m.Shape("plane", transform=m.mu.translate(0, -1, 0),
                        material=m.Material(transparency=0.5,
                                            refractive_index=1.5,
                                            reflective=reflective))
        ball = m.Shape("sphere", transform=m.mu.translate(0, -3.5, -0.5),
                       material=m.Material(
                           pattern=m.Pattern.solid([1.0, 0.0, 0.0]),
                           ambient=0.5))
        return [s1, s2, floor, ball], [light(m, (-10.0, 10.0, -10.0))]
    build.__name__ = f"glass_floor_{reflective}"
    return build


COLOURS = {
    # scene.rs:413-422
    "shading_an_intersection": (default_world, [0, 0, -5], [0, 0, 1], 5,
                                [0.38066, 0.47583, 0.2855], 1e-5),
    # scene.rs:424-435
    "shading_inside": (inside_world, [0, 0, 0], [0, 0, 1], 5,
                       [0.9049844720832575] * 3, 2e-5),
    "ray_misses": (default_world, [0, 0, -5], [0, 1, 0], 5, [0.0] * 3, 0.0),
    # scene.rs:470-496: the ambient-1 inner sphere from inside the outer.
    "behind_the_ray": (ambient_world, [0, 0, 0.75], [0, 0, -1], 5,
                       [1.0] * 3, 2e-5),
    # scene.rs:437-452
    "shadowed": (shadow_world, [0, 0, 5], [0, 0, 1], 5, [0.1] * 3, 2e-5),
    # scene.rs:581-608
    "reflective": (floor_world, [0, 0, -3], [0, -R2, R2], 5,
                   [0.8767572837020907, 0.924340334075874,
                    0.8291742333283075], 2e-5),
    # scene.rs:610-629: the unclamped 11.4 shows the depth limit.
    "mutual_reflection": (mirrors, [0, 0, 0], [0, 1, 0], 5, [11.4] * 3,
                          2e-4),
    # scene.rs:759-795
    "transparent": (glass_floor(0.0), [0, 0, -3], [0, -R2, R2], 2,
                    [0.93642, 0.68642, 0.68642], 1e-4),
    # scene.rs:797-832 (Schlick blending)
    "reflective_transparent": (glass_floor(0.5), [0, 0, -3], [0, -R2, R2], 2,
                               [0.9259077639258646, 0.6864251822976762,
                                0.6764160604069138], 2e-4),
}


@pytest.mark.parametrize("case", sorted(COLOURS))
def test_colour(case):
    """The colour along one ray: the book's value through the port's
    routed color_at and through color_at_aos; color_at against
    rray_tpu's color_at and color_at_aos against its _color_at_sorted at
    1e-9."""
    build, origin, direction, remaining, book, tol = COLOURS[case]
    js, ts = scenes(build)
    (jo, jd), (to, td) = rays(origin, direction)
    key = jax.random.PRNGKey(0)
    routed = tint.color_at(ts, to, td, remaining, TSET, 0).numpy()
    aos = tint.color_at_aos(ts, to, td, remaining, TSET, 0).numpy()
    np.testing.assert_allclose(routed[0], book, atol=tol)
    np.testing.assert_allclose(aos[0], book, atol=tol)
    np.testing.assert_allclose(
        routed, np.asarray(rray_tpu.color_at(js, jo, jd, remaining, JSET,
                                             key)), atol=ATOL)
    np.testing.assert_allclose(
        aos, np.asarray(jint._color_at_sorted(js, jo, jd, remaining, JSET,
                                              key)), atol=ATOL)


# --- the camera (camera.rs:160-205)

@pytest.mark.parametrize("hsize,vsize", [(200, 125), (125, 200)])
def test_pixel_size(hsize, vsize):
    cam = tcam.Camera(hsize, vsize, np.pi / 2)
    assert abs(cam.pixel_size - 0.01) < 1e-9
    assert cam.pixel_size == rray_tpu.Camera(hsize, vsize, np.pi / 2).pixel_size


CAMERA = {
    "centre": (None, 100, 50, [0, 0, 0], [0, 0, -1], 1e-9),
    "corner": (None, 0, 0, None, [0.66519, 0.33259, -0.66851], 1e-5),
    "transformed": (lambda mu: mu.rotate_y(np.pi / 4) @ mu.translate(0, -2, 5),
                    100, 50, [0, 2, -5], [R2, 0, -R2], 1e-9),
}


@pytest.mark.parametrize("case", sorted(CAMERA))
def test_rays_for_pixels(case):
    """ray_for_pixel on a 201x101 camera with a 90 degree field of view:
    the book's ray and rray_tpu's rays_for_pixels at 1e-9."""
    transform, px, py, origin, direction, tol = CAMERA[case]
    tc = tcam.Camera(201, 101, np.pi / 2)
    jc = jcam.Camera(201, 101, np.pi / 2)
    if transform is not None:
        tc.transform, jc.transform = transform(tmu), transform(jmu)
    tc = tcam.compile_camera(tc, torch.float64, "cpu")
    ro, rd = tcam.rays_for_pixels(tc,
                                  torch.tensor([px]), torch.tensor([py]))
    jro, jrd = jcam.rays_for_pixels(jcam.compile_camera(jc, jnp.float64),
                                    jnp.asarray([px]), jnp.asarray([py]))
    if origin is not None:
        np.testing.assert_allclose(ro.numpy()[0], origin, atol=tol)
    np.testing.assert_allclose(rd.numpy()[0], direction, atol=tol)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=ATOL)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=ATOL)


# --- n1/n2 (ray.rs:256-296)

N1N2 = {
    "three_spheres": (glass_spheres, [0, 0, -4], 8,
                      [(1.0, 1.5), (1.5, 2.0), (2.0, 2.5), (2.5, 2.5),
                       (2.5, 1.5), (1.5, 1.0)]),
    # containers_depth 2 < 5 nested spheres: the list is floored at the
    # scene's prim count, so the walk stays exact.
    "five_nested_depth2": (nested_glass, [0, 0, -8], 2,
                           [(1.0, 1.1), (1.1, 1.2), (1.2, 1.3), (1.3, 1.4),
                            (1.4, 1.5), (1.5, 1.4), (1.4, 1.3), (1.3, 1.2),
                            (1.2, 1.1), (1.1, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(N1N2))
def test_refractive_indices(case):
    """n1, n2 at every slot of a ray through nested glass: the book's
    sequence and rray_tpu's refractive_indices."""
    build, origin, depth, book = N1N2[case]
    jset = rray_tpu.RenderSettings(containers_depth=depth)
    tset = rt.RenderSettings(containers_depth=depth)
    want, got, js, ts = both_slots(build, origin, [0, 0, 1], (jset, tset))
    for idx, (e1, e2) in enumerate(book):
        n1, n2 = thits.refractive_indices(ts, got, torch.tensor([idx]), depth)
        j1, j2 = jhits.refractive_indices(js, want, jnp.asarray([idx]), depth)
        assert abs(float(n1[0]) - e1) < 1e-9 and abs(float(n2[0]) - e2) < 1e-9
        assert abs(float(n1[0]) - float(j1[0])) < ATOL
        assert abs(float(n2[0]) - float(j2[0])) < ATOL
