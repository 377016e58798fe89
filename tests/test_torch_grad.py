"""Gradients of the port (rray_tpu_torch) on the CPU, against rray_tpu's
tests/test_grad.py: autograd through render() against central finite
differences at rray_tpu's tolerances and against rray_tpu's jax.grad
(pallas off) leaf by leaf, by key path, at torch_grad_parity.GRAD_TOL
(1e-9 x max(1, |g|), float64); the torus quartic's clamped derivatives;
remat and the compact wavefront's fixed-permutation gradient; the
kernel route's gradient (integrator.WhittedKernel) against the torch
route's (reference_node); the closest-triangle Function's backward
against autograd through the plain version; and canonicalize against
rray_tpu's, exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rray_tpu import Material, Pattern, PointLight, Shape
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_scene as jax_compile_scene
from rray_tpu import mathutils as mu
from rray_tpu.io.obj_loader import load_obj_str
from rray_tpu.io.yaml_loader import load_scene_file as jax_load
from rray_tpu.scene.data import canonicalize as jax_canonicalize
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.ops import jitter, soa
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.parallel import train
from rray_tpu_torch.render import integrator
from rray_tpu_torch.render.camera import all_rays_soa
from rray_tpu_torch.scene import data as sd
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from rray_tpu_torch.kernels import triangles
from torch_grad_parity import (assert_grads_match, jax_grads, pair,
                               port_grads, port_loss)

# rray_tpu's test settings (tests/test_grad.py SET).
KW = dict(rows_per_tile=16, max_hits=4, containers_depth=2)
SET = RenderSettings(**KW)
VIEW = mu.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0])
LIGHT = PointLight(np.array([-10.0, 10.0, -10.0]), np.ones(3))


def small_setup():
    """rray_tpu's small_setup: a plane and a sphere, 16x12."""
    floor = Shape("plane", material=Material(
        pattern=Pattern.solid([0.9, 0.9, 0.9]), specular=0.0))
    ball = Shape("sphere", transform=mu.translate(0, 1, 0),
                 material=Material(pattern=Pattern.solid([0.7, 0.2, 0.2]),
                                   diffuse=0.7, specular=0.3))
    return pair([floor, ball], [LIGHT], 16, 12, np.pi / 3, VIEW)


def glass_setup():
    """rray_tpu's TestWavefrontGradEquivalence scene: a glass ball over a
    reflective floor, 16x12."""
    floor = Shape("plane", material=Material(
        pattern=Pattern.solid([0.9, 0.9, 0.9]), specular=0.0,
        reflective=0.1))
    ball = Shape("sphere", transform=mu.translate(0, 1, 0),
                 material=Material(pattern=Pattern.solid([0.1, 0.1, 0.1]),
                                   diffuse=0.1, specular=1.0, reflective=0.9,
                                   transparency=0.9, refractive_index=1.5))
    return pair([floor, ball], [LIGHT], 16, 12, np.pi / 3, VIEW)


@pytest.fixture(scope="module")
def small():
    (js, jc), (ts, tc) = small_setup()
    return ts, tc, jax_grads(js, jc, JaxSettings(**KW))


def _loss(scene, cam, params, settings=SET):
    target = torch.zeros((cam.vsize, cam.hsize, 3), dtype=torch.float64)
    return float(train.render_loss(params, scene, cam, target, settings))


# Leaves of rray_tpu's TestFiniteDifference: (key path, index, tolerance
# against central differences). prim_inv's silhouette pixels are
# discontinuous, hence rray_tpu's 1e-4 there.
FD_LEAVES = {"material_diffuse": (".mat_diffuse", (1,), 1e-5),
             "material_ambient": (".mat_ambient", (0,), 1e-5),
             "light_intensity": (".lights[0].intensity", (0,), 1e-5),
             "pattern_color": (".patterns[1].color", (0,), 1e-5),
             "object_transform": (".prim_inv", (1, 1, 3), 1e-4)}


@pytest.mark.parametrize("leaf", list(FD_LEAVES))
def test_finite_difference(small, leaf):
    scene, cam, want = small
    key, idx, tol = FD_LEAVES[leaf]
    got = port_grads(scene, cam, SET)
    # Autograd against rray_tpu's jax.grad, every leaf.
    assert_grads_match(got, want)
    params, rest = train.partition_scene(scene)
    eps = 1e-6

    def bumped(d):
        p = dict(params)
        p[key] = params[key].clone()
        p[key][idx] += d
        return _loss(rest, cam, p)

    fd = (bumped(eps) - bumped(-eps)) / (2 * eps)
    auto = float(got[key][idx])
    assert abs(auto - fd) <= tol * max(1.0, abs(fd)), (auto, fd)


def test_torus_radius_finite_difference():
    """rray_tpu's TestTorusGrad: every leaf finite through the torus
    quartic's clamped sqrt/cbrt/acos (ops/quartic.py), d(loss)/d(tor_r)
    against central differences, and every leaf against rray_tpu."""
    floor = Shape("plane", material=Material(
        pattern=Pattern.solid([0.9, 0.9, 0.9]), specular=0.0))
    torus = Shape("torus", minor_radius=0.3,
                  transform=mu.compose([mu.translate(0, 0.3, 0),
                                        mu.rotate_x(np.pi / 2)]),
                  material=Material(pattern=Pattern.solid([0.7, 0.3, 0.2]),
                                    specular=0.0))
    (js, jc), (scene, cam) = pair(
        [floor, torus], [LIGHT], 24, 16, np.pi / 3,
        mu.view_transform([0, 1.5, -4], [0, 0.5, 0], [0, 1, 0]))
    kw = dict(KW, max_hits=8, containers_depth=4)
    st = RenderSettings(**kw)
    assert integrator.route(scene) == "kernel"
    got = port_grads(scene, cam, st)
    for key, g in got.items():
        assert np.isfinite(g).all(), key
    assert_grads_match(got, jax_grads(js, jc, JaxSettings(**kw)))
    params, rest = train.partition_scene(scene)
    eps = 1e-6

    def bumped(d):
        p = dict(params, **{".tor_r": params[".tor_r"] + d})
        return _loss(rest, cam, p, st)

    fd = (bumped(eps) - bumped(-eps)) / (2 * eps)
    auto = float(got[".tor_r"][0])
    assert auto != 0.0
    assert abs(auto - fd) <= 1e-5 * max(1.0, abs(fd)), (auto, fd)


@pytest.fixture(scope="module")
def glass():
    return glass_setup()[1]


def test_remat_identity(glass):
    """settings.remat (torch.utils.checkpoint per level) changes no
    gradient (rray_tpu's test_remat_identity, its tolerances)."""
    scene, cam = glass
    base = RenderSettings(**dict(KW, max_hits=8, containers_depth=4))
    a = port_grads(scene, cam, dataclasses.replace(base, remat=True))
    b = port_grads(scene, cam, dataclasses.replace(base, remat=False))
    assert any(np.abs(v).max() > 0 for v in a.values() if v.size)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-12, atol=1e-14,
                                   err_msg=key)


def test_compact_full_capacity_matches_scan(glass):
    """The compact wavefront at 2^depth paths per pixel keeps every path:
    its gradient, through the sort's fixed permutation, equals the
    exhaustive scan's (rray_tpu's test, its tolerances)."""
    scene, cam = glass
    base = RenderSettings(**dict(KW, max_hits=8, containers_depth=4),
                          wavefront_capacity=2 ** 5)
    a = port_grads(scene, cam, dataclasses.replace(base, wavefront="compact"))
    b = port_grads(scene, cam, dataclasses.replace(base, wavefront="scan"))
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-9, atol=1e-12,
                                   err_msg=key)


def test_compact_topw_gradient_is_the_fixed_permutation():
    """_compact_topw's gradient: each kept row's cotangent goes to its
    source row (torch.sort's indices carry none), and the keys get none
    (rray_tpu's custom VJP and its stop_gradient on -cw)."""
    torch.manual_seed(0)
    W, R = 2, 5
    cw = torch.rand(2 * W, R, dtype=torch.float64)
    cw[1, 2] = 0.0
    cw.requires_grad_()
    op = torch.rand(2 * W, R, dtype=torch.float64, requires_grad=True)
    kept_w, kept_op = integrator._compact_topw(W, cw, (cw, op))
    ct_w = torch.rand(W, R, dtype=torch.float64)
    ct_op = torch.rand(W, R, dtype=torch.float64)
    gw, gop = torch.autograd.grad(
        (kept_w * ct_w).sum() + (kept_op * ct_op).sum(), (cw, op))
    order = torch.sort(torch.where(cw == 0.0, 0.0, -cw.detach()), dim=0,
                       stable=True).indices[:W]
    want_w = torch.zeros_like(cw).scatter(0, order, ct_w)
    want_op = torch.zeros_like(op).scatter(0, order, ct_op)
    assert torch.equal(gw, want_w) and torch.equal(gop, want_op)


def _ref_image(scene, cam, settings, seed=0):
    ro, rd = all_rays_soa(cam)
    seeds = jitter.seed_table(seed, settings.depth, len(scene.lights))
    out = integrator.reference_node(scene, ro, rd, settings.depth, settings,
                                    seeds)
    return torch.stack((out.x, out.y, out.z), -1).reshape(cam.vsize,
                                                         cam.hsize, 3)


def _yaml_pair(path, size=(16, 12)):
    spec, lights, shapes = jax_load(path)
    return pair(shapes, lights, *size, spec["fov"], spec["transform"])


@pytest.mark.parametrize("name", ["example1", "glass", "mesh4"])
def test_kernel_route_matches_torch_route(name, tmp_path):
    """render() on the kernel route (WhittedKernel: the whitted kernel's
    plain version forward, reference_node recomputed in batches
    backward) against reference_node under autograd over every ray at
    once: the same image and the same gradients, leaf by leaf."""
    path = (ms.write_scene(str(tmp_path), name, lat_lon=(11, 11))
            if name == "mesh4" else f"{ms.EXAMPLES}/{name}.yaml")
    scene, cam = _yaml_pair(path)[1]
    assert integrator.route(scene) == "kernel"
    # Batches of 3 raster rows: the backward sums five batches.
    st = RenderSettings(rows_per_tile=3)
    loss, params = port_loss(scene, cam, st)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    p2 = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    image = _ref_image(sd.canonicalize(train.merge_scene(p2, scene)), cam, st)
    with torch.no_grad():
        kernel_image = integrator.render(scene, cam, st)
    np.testing.assert_allclose(kernel_image.numpy(), image.detach().numpy(),
                               rtol=0, atol=1e-9)
    want = torch.autograd.grad(torch.mean(image ** 2), list(p2.values()),
                               allow_unused=True)
    z = lambda g, v: (torch.zeros_like(v) if g is None else g).numpy()
    assert_grads_match({k: z(g, v) for (k, v), g in zip(params.items(), got)},
                       {k: z(g, v) for (k, v), g in zip(p2.items(), want)})


def _mesh_scene(lat_lon):
    """A UV-sphere mesh over a floor, compiled in float64, and rays from
    the mesh scenes' camera (16x12)."""
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.render.camera import Camera, compile_camera
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        spec, lights, shapes = load_scene_file(
            ms.write_scene(tmp, "m", lat_lon=lat_lon))
    scene = sd.compile_scene(shapes, lights, dtype=torch.float64, device="cpu")
    cam = Camera(16, 12, spec["fov"])
    cam.transform = spec["transform"]
    return scene, all_rays_soa(compile_camera(cam, torch.float64, "cpu"))


@pytest.mark.parametrize("route", ["closest_triangle", "bvh_closest_triangle"])
def test_closest_function_backward_matches_plain_autograd(route):
    """soa.ClosestTriangle (winner held fixed, its row recomputed,
    index_add_ into the tables) against autograd straight through the
    plain version, for the chunk kernel's route (the mesh below
    bvh_min_tris) and the BVH kernel's (above): the same gradients into
    the six triangle tables and the rays; none into t_init."""
    scene, (ro, rd) = _mesh_scene((6, 6))
    T = scene.counts[6]
    st = RenderSettings(bvh_min_tris=T if route == "bvh_closest_triangle"
                        else T + 1)
    names = ("tri_p1", "tri_e1", "tri_e2", "tri_n1", "tri_n2", "tri_n3")
    rng = np.random.default_rng(0)
    weights = [torch.from_numpy(rng.normal(size=ro.x.shape[0]))
               for _ in range(4)]

    def run(use_function):
        tabs = {n: getattr(scene, n).clone().requires_grad_() for n in names}
        rays = [c.clone().requires_grad_() for c in (ro.x, ro.y, ro.z, rd.x,
                                                       rd.y, rd.z)]
        t_init = torch.full_like(rays[0], 1e3).requires_grad_()
        if use_function:
            s = dataclasses.replace(scene, **tabs)
            t, _, _, n, _ = soa._triangle_best(s, V3(*rays[:3]),
                                               V3(*rays[3:]), st, t_init)
        else:
            comps = tuple(tabs[n][:, j] for n in names for j in range(3))
            t, _, _, _, *n = triangles.closest_triangle_reference(
                rays[:3], rays[3:], comps, t_init=t_init)
        found = torch.isfinite(t)
        loss = sum((torch.where(found, c, 0.0) * w).sum()
                   for c, w in zip((t, *n), weights))
        inputs = list(tabs.values()) + rays + [t_init]
        return torch.autograd.grad(loss, inputs, allow_unused=True), found

    got, found = run(True)
    want, _ = run(False)
    assert 0 < int(found.sum()) < found.numel()
    assert got[-1] is None  # t_init
    for k, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * scale, err_msg=str(k))


def _all_kinds_scene(dtype):
    """Every analytic kind (closed cylinder and cone, a torus), a
    triangle mesh and a CSG, compiled in rray_tpu."""
    tet = load_obj_str(ms.TETRAHEDRON,
                       Material(pattern=Pattern.solid([0.7, 0.5, 0.2])))
    shapes = [
        Shape("plane"),
        Shape("sphere", transform=mu.translate(-2, 1, 0)),
        Shape("cube", transform=mu.translate(2, 1, 0)),
        Shape("cylinder", minimum=-1.0, maximum=1.5, closed=True,
              transform=mu.translate(0, 1, 3)),
        Shape("cone", minimum=-1.0, maximum=0.0, closed=True,
              transform=mu.translate(0, 1, -3)),
        Shape("torus", minor_radius=0.25, transform=mu.translate(3, 1, 3)),
        Shape("csg", operation="difference",
              left=Shape("cube", transform=mu.translate(-3, 1, 3)),
              right=Shape("sphere", transform=mu.translate(-3, 1.5, 3))),
        tet]
    return jax_compile_scene(shapes, [LIGHT], dtype=dtype)


def _desynced(fields):
    """The derived copies of a scene's fields out of step with their
    sources, as after an optimizer step: every float leaf moved by a
    seeded amount."""
    rng = np.random.default_rng(1)
    out = dict(fields)
    for name in sd.TENSOR_FIELDS:
        a = np.asarray(fields[name])
        if np.issubdtype(a.dtype, np.floating):
            out[name] = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
    return out


@pytest.mark.parametrize("case", ["compiled", "desynced"])
def test_canonicalize_matches_rray_tpu(case):
    """canonicalize equals rray_tpu's, exactly, leaf by leaf: on a
    freshly compiled scene (every leaf unchanged) and on one whose
    derived copies drifted from their sources."""
    import jax

    jscene = _all_kinds_scene(jnp.float64)
    fields, meta = scene_to_numpy(jscene)
    if case == "desynced":
        fields = _desynced(fields)
        flat, treedef = jax.tree_util.tree_flatten_with_path(jscene)
        jscene = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(fields[jax.tree_util.keystr(p)[1:]])
            if jax.tree_util.keystr(p)[1:] in fields else v
            for p, v in flat])
    scene = scene_from_numpy(fields, meta, device="cpu")
    want = scene_to_numpy(jax_canonicalize(jscene))[0]
    got = scene_to_numpy(sd.canonicalize(scene))[0]
    for name in sd.TENSOR_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if case == "compiled":
        for name in sd.TENSOR_FIELDS:
            np.testing.assert_array_equal(got[name], fields[name])
    else:
        assert not np.array_equal(got["cls_table"], fields["cls_table"])


def test_requires_grad_after_a_render_reaches_the_leaf():
    """A scene rendered once without grad (its canonical scene and
    kernel tables cached), then given a leaf that requires grad in
    place, gets the same gradient as a fresh copy: the canonical scene
    and the torch folds' tables are not reused while a leaf requires
    grad."""
    scene, cam = _mesh_pair()
    fresh = scene_from_numpy(*scene_to_numpy(scene), device="cpu")
    with torch.no_grad():
        integrator.render(scene, cam, SET)
    grads = []
    for s in (scene, fresh):
        for name in ("mat_diffuse", "tri_p1"):
            getattr(s, name).requires_grad_()
        loss = torch.mean(integrator.render(s, cam, SET) ** 2)
        grads.append(torch.autograd.grad(loss, (s.mat_diffuse, s.tri_p1)))
    for got, want in zip(*grads):
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)


def _mesh_pair():
    """A transparent 16-triangle mesh over a floor (the sorted node's
    torch folds), float64, 16x12."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return _yaml_pair(ms.write_scene(tmp, "glassmesh", lat_lon=(3, 4),
                                         glass=True))[1]
