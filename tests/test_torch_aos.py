"""The port's per-ray reference path and its "unrolled" wavefront against
rray_tpu, on whole frames at 16x12 in float64.

- color_at_aos (rray_tpu_torch/render/integrator.py) against rray_tpu's
  _color_at_sorted at 1e-9 on the camera rays of seven scenes: glass
  (point light), example1, a 200-triangle glass mesh, a nested CSG with
  a torus over a reflective floor, config 5 (CSG, a torus, Perlin noise,
  an image texture), config 3 (an area light: rray_tpu's per-node key
  chain) and area glass spheres;
- render_aos against the port's routed frames (render() at
  wavefront_capacity 2^depth, where no path is dropped) at 1e-9 under
  point lights: the whitted kernel's plain version, the fast node and
  the sorted node;
- the "unrolled" wavefront against rray_tpu's _color_at_sorted_unrolled
  at 1e-9 on every scene, and through render() against the port's
  "scan" frame; under both, route() sends CSG and transparency to the
  sorted node, as rray_tpu's dispatcher does.

The inputs are the same on both sides: each scene is compiled by
rray_tpu and handed to the port through scene/convert.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.io.yaml_loader as jax_yaml
import torch_parity as tp
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_scene
from rray_tpu.render import camera as jcam
from rray_tpu.render import integrator as jint
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.render import camera, integrator
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

ATOL = 1e-9
W, H = 16, 12
SEED = 3
CSG_TORUS = """\
camera: {fov: 60, from: [0, 2.5, -6], to: [0, 1.2, 0], up: [0, 1, 0]}
lights:
  - {type: point, position: [-10, 10, -10], color: [1, 1, 1]}
scene:
  - type: plane
    material:
      pattern: {type: ring, color_a: [0.9, 0.9, 0.9], color_b: [0.2, 0.3, 0.5]}
      reflective: 0.3
      specular: 0
  - type: csg
    operation: difference
    transforms: [{type: translate, amount: [0, 1.5, 0]}]
    left:
      type: csg
      operation: union
      left:
        type: sphere
        transforms: [{type: scale, amount: [0.6, 0.6, 0.6]}]
        material:
          pattern:
            type: stripe
            color_a: [1, 0.2, 0.2]
            color_b: [1, 1, 0.3]
            transforms: [{type: scale, amount: [0.2, 0.2, 0.2]}]
      right:
        type: torus
        minor_radius: 0.25
        material: {pattern: {type: solid, color: [0.2, 0.8, 0.3]}, reflective: 0.4}
    right:
      type: cube
      transforms:
        - {type: scale, amount: [0.5, 0.5, 0.5]}
        - {type: translate, amount: [0.9, 0.9, -0.3]}
"""
# name -> (writer of the scene file under a directory, depth, tri_chunk,
# point lights only).
SCENES = {
    "glass": (lambda tmp: tp.GLASS, 3, 512, True),
    "example1": (lambda tmp: tp.EXAMPLE1, 3, 512, True),
    "glassmesh": (lambda tmp: ms.write_scene(tmp, "glassmesh",
                                             lat_lon=(10, 10), glass=True),
                  2, 64, True),
    "csgtorus": (lambda tmp: _write(tmp, "csgtorus", CSG_TORUS), 3, 512, True),
    "config5": (lambda tmp: os.path.join(tp.BASE, "examples",
                                         "csg_showcase.yaml"), 2, 512, True),
    "area": (lambda tmp: os.path.join(tp.BASE, "examples", "area_light.yaml"),
             2, 512, False),
    "areaglass": (lambda tmp: ms.write_scene(
        tmp, "areaglass", lat_lon=None, spheres=3, reflective=0.3,
        area_level=2, glass=True), 2, 512, False),
}
POINT = sorted(n for n, s in SCENES.items() if s[3])


def _write(tmp, name, text):
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("aos"))


def _case(tmp, name):
    """(path, rray_tpu scene, the port's scene, rray_tpu settings, the
    port's settings, rray_tpu camera, the port's camera) in float64, at
    full wavefront capacity."""
    write, depth, chunk, _ = SCENES[name]
    path = write(tmp)
    cam_spec, lights, shapes = jax_yaml.load_scene_file(path)
    jscene = compile_scene(shapes, lights, dtype=jnp.float64)
    tscene = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    jc = jcam.Camera(W, H, cam_spec["fov"])
    jc.transform = cam_spec["transform"]
    tc = camera.Camera(W, H, cam_spec["fov"])
    tc.transform = cam_spec["transform"]
    return (path, jscene, tscene,
            JaxSettings(pallas="off", depth=depth, tri_chunk=chunk,
                        wavefront_capacity=2 ** depth),
            RenderSettings(depth=depth, tri_chunk=chunk,
                           wavefront_capacity=2 ** depth),
            jcam.compile_camera(jc, jnp.float64),
            camera.compile_camera(tc, torch.float64, "cpu"))


@pytest.fixture(scope="module")
def aos_frames(tmp):
    """name -> (the case, the port's AoS frame [R, 3]), rendered once."""
    out = {}
    for name in SCENES:
        case = _case(tmp, name)
        ro, rd = camera.all_rays(case[6])
        out[name] = case, integrator.color_at_aos(
            case[2], ro, rd, case[4].depth, case[4], SEED).numpy()
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_aos_frame_matches_rray_tpu(aos_frames, name):
    """color_at_aos against rray_tpu's _color_at_sorted on the camera
    rays (rays_for_pixels against rray_tpu's too), area lights by the
    per-node key chain."""
    (_, jscene, _, jset, tset, jc, tc), got = aos_frames[name]
    jro, jrd = jcam.all_rays(jc)
    ro, rd = camera.all_rays(tc)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=ATOL)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=ATOL)
    want = np.asarray(jint._color_at_sorted(
        jscene, jro, jrd, jset.depth, jset,
        jax.random.PRNGKey(np.int32(SEED))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.max() > 0.1


@pytest.mark.parametrize("name", POINT)
def test_aos_frame_matches_routes(aos_frames, name):
    """render_aos against render() on the scene's route at full capacity
    (the whitted kernel's plain version, the fast node or the sorted
    node), point lights only: the two key chains differ, so area-light
    frames draw other jitter."""
    (_, _, tscene, _, tset, _, tc), frame = aos_frames[name]
    aos = integrator.render_aos(tscene, tc, tset, SEED).numpy()
    np.testing.assert_array_equal(aos.reshape(-1, 3), frame)
    routed = integrator.render(tscene, tc, tset, SEED).numpy()
    np.testing.assert_allclose(aos, routed, rtol=0, atol=ATOL,
                               err_msg=integrator.route(tscene, tset))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_unrolled_matches_rray_tpu(tmp, name):
    """The sorted node's "unrolled" wavefront against rray_tpu's
    _color_at_sorted_unrolled (seeds from seed_table: fold_in(key,
    level) per level)."""
    _, jscene, tscene, jset, tset, jc, tc = _case(tmp, name)
    jro, jrd = jcam.all_rays_soa(jc)
    ro, rd = camera.all_rays_soa(tc)
    want = jint._color_at_sorted_unrolled(
        jscene, jro, jrd, jset.depth, jset,
        jax.random.PRNGKey(np.int32(SEED)))
    got = integrator.color_at_sorted(
        tscene, ro, rd, tset.depth,
        RenderSettings(depth=tset.depth, tri_chunk=tset.tri_chunk,
                       wavefront="unrolled"),
        jitter.seed_table(SEED, tset.depth, len(tscene.lights)))
    for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["areaglass", "config5", "csgtorus",
                                  "glass", "glassmesh"])
def test_unrolled_render_matches_scan(tmp, name):
    """render() under "unrolled" routes CSG and transparency to the
    sorted node (the kernel's scenes included) and gives the "scan"
    frame; the order of the per-pixel sums differs, so 1e-9."""
    _, _, tscene, _, tset, _, tc = _case(tmp, name)
    unrolled = RenderSettings(depth=tset.depth, tri_chunk=tset.tri_chunk,
                              wavefront="unrolled")
    scan = RenderSettings(depth=tset.depth, tri_chunk=tset.tri_chunk,
                          wavefront="scan")
    assert integrator.route(tscene, unrolled) == "sorted"
    np.testing.assert_allclose(
        integrator.render(tscene, tc, unrolled, SEED).numpy(),
        integrator.render(tscene, tc, scan, SEED).numpy(), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("wavefront", ["scan", "unrolled"])
def test_wavefront_routes_as_rray_tpu(tmp, wavefront):
    """rray_tpu tries its whitted kernel under "compact" alone: under
    "scan" and "unrolled" glass (transparent) and config 5 (CSG) leave
    the kernel for the sorted node, while example1 and config 3 (no CSG,
    no transparency) stay on it."""
    for name in ("example1", "area", "glass", "config5"):
        tscene = _case(tmp, name)[2]
        assert integrator.route(tscene) == "kernel"
        assert integrator.route(tscene, RenderSettings()) == "kernel"
        want = ("sorted" if tscene.has_transparent or tscene.csg_ops
                else "kernel")
        assert integrator.route(
            tscene, RenderSettings(wavefront=wavefront)) == want, name


def test_unrolled_through_render_scene_from_file(tmp):
    """The public entry point takes RenderSettings(wavefront="unrolled")
    end to end (the CPU's plain versions) and gives the "scan" image."""
    path = SCENES["glass"][0](tmp)
    images = [api.render_scene_from_file(
        path, W, H, os.path.join(tmp, f"{wf}.png"), settings=RenderSettings(
            depth=2, wavefront=wf), dtype=torch.float64, device="cpu")
        for wf in ("unrolled", "scan")]
    assert images[0].shape == (H, W, 3) and images[0].max() > 0.1
    np.testing.assert_allclose(images[0], images[1], rtol=0, atol=ATOL)
    assert os.path.getsize(os.path.join(tmp, "unrolled.png")) > 0


def _seeded(n=300):
    """n seeded rays around the scenes' cameras, as [R, 3] numpy."""
    o, d = tp.seeded_rays(np.float64, n=n)
    return o.T.copy(), d.T.copy()


@pytest.mark.parametrize("name", ["config5", "csgtorus", "glassmesh"])
def test_hit_queries_match_rray_tpu(tmp, name):
    """ops/hits.py against rray_tpu's ops/hits.py on seeded rays: the
    sorted, CSG-filtered slots (the mesh in chunks of 64), select_hit,
    closest_hit (equal to select_hit where no CSG filters), shadow_hit
    at the hit distances, and the containers walk's n1/n2 at the hit."""
    from rray_tpu.ops import hits as jhits
    from rray_tpu_torch.ops import hits

    _, jscene, tscene, jset, tset, _, _ = _case(tmp, name)
    o, d = _seeded()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    want = jhits.gather_sorted_hits(jscene, jo, jd, jset)
    got = hits.gather_sorted_hits(tscene, to, td, tset)
    for field in ("t", "prim", "u", "v", "valid"):
        np.testing.assert_allclose(
            getattr(got, field).numpy().astype(np.float64),
            np.asarray(getattr(want, field)).astype(np.float64), rtol=0,
            atol=ATOL, err_msg=field)
    sel = hits.select_hit(got)
    jsel = jhits.select_hit(want)
    for a, b in zip(sel, jsel):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=0, atol=ATOL)
    found = sel[0].numpy()
    assert found.any() and not found.all()
    closest = hits.closest_hit(tscene, to, td, tset)
    jclosest = jhits.closest_hit(jscene, jo, jd, jset)
    for a, b in zip(closest, jclosest):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=0, atol=ATOL)
    if not tscene.csg_ops:
        np.testing.assert_array_equal(closest[0].numpy(), found)
        np.testing.assert_allclose(closest[1].numpy()[found],
                                   sel[2].numpy()[found], rtol=0, atol=ATOL)
    dist = torch.where(sel[0], sel[2] * 0.5, torch.full_like(sel[2], 3.0))
    np.testing.assert_array_equal(
        hits.shadow_hit(tscene, to, td, dist, tset).numpy(),
        np.asarray(jhits.shadow_hit(jscene, jo, jd, jnp.asarray(dist.numpy()),
                                    jset)))
    if tscene.has_transparent:
        n1n2 = hits.refractive_indices(tscene, got, sel[1], 8)
        jn1n2 = jhits.refractive_indices(jscene, want, jsel[1], 8)
        for a, b in zip(n1n2, jn1n2):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)


def test_sort_slots_is_stable_and_ranks_negative_zero_with_zero():
    """_sort_slots as lax.sort(num_keys=1, is_stable=True): ties keep
    their order, -0.0 ties with +0.0 (torch.sort alone puts it first),
    +inf padding sorts last; only the first k are kept."""
    from rray_tpu_torch.ops import hits

    t = torch.tensor([[0.0, -0.0, 2.0, float("inf"), 2.0, -1.0]],
                     dtype=torch.float64)
    prim = torch.arange(6, dtype=torch.int32)[None]
    u = t.clone()
    ts, ps, _, _ = hits._sort_slots(t, prim, u, u, 5)
    assert ps.tolist() == [[5, 0, 1, 2, 4]]
    assert torch.signbit(ts[0, 2]) and not torch.signbit(ts[0, 1])


def test_solve_quartic_and_slot_count_match_rray_tpu(tmp):
    """solve_quartic (solve_quartic_parts stacked on a last axis) and
    analytic_slot_count against rray_tpu's."""
    from rray_tpu.ops import quartic as jquartic
    from rray_tpu.scene import data as jsd
    from rray_tpu_torch.ops import quartic
    from rray_tpu_torch.scene import data as sd

    coeffs = np.random.default_rng(7).normal(size=(5, 64))
    roots, valid = quartic.solve_quartic(
        *(torch.from_numpy(c) for c in coeffs), safe_transcendentals=True)
    jroots, jvalid = jquartic.solve_quartic(*(jnp.asarray(c) for c in coeffs))
    assert roots.shape == (64, 4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = valid.numpy()
    np.testing.assert_allclose(roots.numpy()[v], np.asarray(jroots)[v],
                               rtol=1e-9, atol=1e-9)
    for name in ("config5", "csgtorus", "glass"):
        _, jscene, tscene = _case(tmp, name)[:3]
        assert sd.analytic_slot_count(tscene) == jsd.analytic_slot_count(
            jscene)


def test_sphere_and_plane_constructors_match_rray_tpu():
    """scene/data.py's test constructors build rray_tpu's leaves."""
    import rray_tpu.scene.data as jsd
    from rray_tpu_torch import mathutils as mu
    from rray_tpu_torch.scene import data as sd

    for make, jmake in ((sd.sphere, jsd.sphere), (sd.plane, jsd.plane)):
        a, b = make(mu.translate(1, 2, 3)), jmake(mu.translate(1, 2, 3))
        assert a.kind == b.kind
        np.testing.assert_array_equal(a.transform, b.transform)
        for field in ("ambient", "diffuse", "specular", "shininess",
                      "reflective", "transparency", "refractive_index"):
            assert getattr(a.material, field) == getattr(b.material, field)
        np.testing.assert_array_equal(make().transform, np.eye(4))
