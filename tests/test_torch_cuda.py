"""rray_tpu_torch's CUDA kernels on the card. Marked `cuda`: skipped where
torch.cuda.is_available() is False; on a GPU machine (no JAX there, so
without tests/conftest.py) run with
`python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py`,
from any directory: the file puts the repository root on sys.path (with
--noconftest pytest adds only tests/)."""
import os
import sys

import numpy as np
import pytest
import torch

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BASE not in sys.path:
    sys.path.insert(0, BASE)

from rray_tpu_torch import api  # noqa: E402
from rray_tpu_torch.config import RenderSettings  # noqa: E402
from rray_tpu_torch.io import mesh_scenes as ms  # noqa: E402
from rray_tpu_torch.io.yaml_loader import load_scene_file  # noqa: E402
from rray_tpu_torch.kernels import (  # noqa: E402
    analytic, bvh, downsample, triangles, whitted)
from rray_tpu_torch.render import canvas  # noqa: E402
from rray_tpu_torch.render.camera import (  # noqa: E402
    Camera, all_rays_soa, compile_camera)
from rray_tpu_torch.render.integrator import render  # noqa: E402
from rray_tpu_torch.scene.data import compile_scene  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(name, device, cap=4, w=160, h=120):
    cam_spec, lights, shapes = load_scene_file(
        name if os.path.isabs(name) else os.path.join(BASE, "examples", name))
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=device)
    cam = Camera(w, h, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, device))
    return (((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z)),
            whitted.kernel_inputs(scene,
                                  RenderSettings(wavefront_capacity=cap)))


@pytest.mark.parametrize("name,cap", [("example1.yaml", 4), ("glass.yaml", 1),
                                      ("glass.yaml", 4), ("glass.yaml", 32)])
def test_kernel_matches_plain_version(cuda, name, cap):
    rays, inputs = _args(name, cuda, cap)
    before = whitted.launches
    kern = torch.stack(whitted.whitted_compact(*rays, **inputs))
    assert whitted.launches == before + 1
    plain = torch.stack(whitted.whitted_compact_reference(*rays, **inputs))
    torch.cuda.synchronize()
    # --fmad=false: the kernel rounds as the plain version does; only
    # rsqrtf/powf ulps may differ (measured: bit-identical at 800x600).
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float((diff <= 1e-6).double().mean()) >= 0.999


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    (rays_o, rays_d), inputs = _args("glass.yaml", cuda, 4, 8, 6)
    f64 = tuple(c.double() for c in rays_o)
    with pytest.raises(TypeError, match="float32"):
        whitted.whitted_compact(f64, rays_d, **inputs)
    with pytest.raises(ValueError, match="W=3"):
        whitted.whitted_compact(rays_o, rays_d, **{**inputs, "W": 3})
    strided = tuple(torch.zeros(12, device=cuda)[::2] for _ in range(3))
    with pytest.raises(ValueError, match="contiguous"):
        whitted.whitted_compact(strided, strided, **inputs)


@pytest.mark.parametrize("reflective", [0.0, 0.3])
def test_mesh_kernel_matches_plain_version(cuda, reflective, tmp_path):
    """Stage d: the in-kernel mesh, at depth 0 and along the chain."""
    path = ms.write_scene(str(tmp_path), "mesh", reflective=reflective)
    cam_spec, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=cuda)
    cam = Camera(160, 120, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, cuda))
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    kern = torch.stack(whitted.whitted_compact(*rays, **inputs))
    plain = torch.stack(whitted.whitted_compact_reference(*rays, **inputs))
    torch.cuda.synchronize()
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float((diff <= 1e-6).double().mean()) >= 0.999


def _seeded(T, device, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, (3, T))
    cols = [*(centers + rng.uniform(-0.3, 0.3, (3, T))),
            *rng.uniform(-0.6, 0.6, (6, T)), *rng.normal(size=(9, T))]
    R = 4096
    o = rng.uniform(-1, 1, (3, R)) + np.array([[0.0], [0.0], [-8.0]])
    d = rng.uniform(-0.3, 0.3, (3, R)) + np.array([[0.0], [0.0], [1.0]])
    d /= np.linalg.norm(d, axis=0)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return ((tuple(t(c) for c in o), tuple(t(c) for c in d)),
            tuple(t(c) for c in cols), t(rng.uniform(4.0, 12.0, R)))


@pytest.mark.parametrize("kind", ["closest", "any", "bvh", "bvh_any",
                                  "bvh_large", "bvh_large_any"])
def test_triangle_kernels_match_plain_versions(cuda, kind):
    """B2, B3 and B4; the BVH kernel on 1536 triangles stages its tables
    in shared memory, on 20,000 (bvh_large) it reads them through L1."""
    use_bvh = kind.startswith("bvh")
    T = 20000 if "large" in kind else 1536 if use_bvh else 200
    rays, cols, bound = _seeded(T, cuda)
    if use_bvh:
        assert (4 * bvh.card_tables(cols[:9]).block.numel()
                <= bvh.STAGE_BYTES) == (T == 1536)
    aux = (torch.arange(cols[0].shape[0], dtype=torch.float32, device=cuda),)
    if kind == "any":
        before = triangles.any_launches
        kern = triangles.any_triangle(*rays, cols[:9], bound)
        plain = triangles.any_triangle_reference(*rays, cols[:9], bound)
        assert triangles.any_launches == before + 1
        assert float((kern == plain).double().mean()) >= 0.999
        return
    if kind.endswith("any"):
        kern = bvh.bvh_closest_triangle(*rays, cols[:9], dist=bound,
                                        any_hit=True)
        plain = bvh.bvh_closest_triangle_reference(*rays, cols[:9],
                                                   dist=bound, any_hit=True)
        assert float((kern[0] == plain[0]).double().mean()) >= 0.999
        return
    fn = bvh.bvh_closest_triangle if use_bvh else triangles.closest_triangle
    ref = (bvh.bvh_closest_triangle_reference if use_bvh
           else triangles.closest_triangle_reference)
    seed = {"dist": bound} if use_bvh else {"t_init": bound}
    for extra in ({}, seed):
        kern = fn(*rays, cols, aux=aux, **extra)
        plain = ref(*rays, cols, aux=aux, **extra)
        torch.cuda.synchronize()
        same = kern[3] == plain[3]
        assert float(same.double().mean()) >= 0.999
        assert bool(torch.isfinite(kern[0]).any())
        for a, b in zip(kern, plain):
            both = torch.isinf(a) & torch.isinf(b)
            assert bool(((a.float() - b.float()).abs() <= 1e-5)
                        [same & ~both].all())


@pytest.mark.parametrize("placement", ["staged", "L1"])
@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("T", [540, 1008, 2500])
def test_triangle_kernels_with_tables(cuda, kind, placement, T,
                                      monkeypatch):
    """B2 and B3 with the scene's tables (chunk_tables, built once and
    shared by the closest and any-hit calls) and without them (built per
    call), on 540 and 1008 triangles (mesh9's and mesh9k's counts) and
    on 2500, with the tables staged in shared memory by the persistent
    grid, and read through L1 by the plain grid (STAGE_BYTES = 0)."""
    if placement == "L1":
        monkeypatch.setattr(triangles, "STAGE_BYTES", 0)
    rays, cols, bound = _seeded(T, cuda, seed=T)
    aux = (torch.arange(T, dtype=torch.float32, device=cuda),
           torch.full((T,), 3.0, device=cuda))
    tables = triangles.chunk_tables(cols, aux)
    assert tables.block.device.type == "cuda"
    if kind == "any":
        plain = triangles.any_triangle_reference(*rays, cols[:9], bound)
        before = triangles.any_launches
        for tbl in (tables, None):
            kern = triangles.any_triangle(*rays, cols[:9], bound, tables=tbl)
            assert float((kern == plain).double().mean()) >= 0.999
        assert triangles.any_launches == before + 2
        assert 0.0 < float(plain.double().mean()) < 1.0
        return
    before = triangles.closest_launches
    for seed in ({}, {"t_init": bound}):
        plain = triangles.closest_triangle_reference(*rays, cols, aux=aux,
                                                     **seed)
        for tbl in (tables, None):
            kern = triangles.closest_triangle(*rays, cols, aux=aux,
                                              tables=tbl, **seed)
            torch.cuda.synchronize()
            same = kern[3] == plain[3]
            assert float(same.double().mean()) >= 0.999
            assert bool(torch.isfinite(kern[0]).any())
            for a, b in zip(kern, plain):
                both = torch.isinf(a) & torch.isinf(b)
                assert bool(((a.float() - b.float()).abs() <= 1e-5)
                            [same & ~both].all())
    assert triangles.closest_launches == before + 4


def test_area9_launches_both_triangle_kernels(cuda, tmp_path):
    """area9: nine 60-triangle meshes under config 3's light (level 5)
    leave the whitted kernel for the fast node, whose closest call and
    five sample-row any-hit calls per level launch B2 and B3 with one set
    of tables for the scene."""
    path = ms.write_scene(str(tmp_path), "area9", lat_lon=(6, 6), grid=True,
                          area_level=5)
    counts = (triangles.closest_launches, triangles.any_launches,
              triangles.table_builds)
    image = api.render_scene_from_file(path, 64, 48, "", device="cuda")
    assert np.isfinite(image).all()
    assert triangles.closest_launches >= counts[0] + 1
    assert triangles.any_launches >= counts[1] + 5
    assert triangles.table_builds == counts[2] + 1


@pytest.mark.parametrize("grid,lat_lon", [(True, (6, 6)), (False, (40, 40))])
def test_fast_node_launches_triangle_kernels(cuda, grid, lat_lon, tmp_path):
    """Nine mesh groups (B2 + B3) and a 3120-triangle mesh (B4) leave the
    whitted kernel for the fast node, which launches the triangle
    kernels on the main path."""
    path = ms.write_scene(str(tmp_path), "fast", lat_lon=lat_lon, grid=grid)
    counts = (triangles.closest_launches, triangles.any_launches,
              bvh.launches)
    image = api.render_scene_from_file(path, 64, 48, "", device="cuda")
    assert np.isfinite(image).all()
    if grid:
        assert triangles.closest_launches > counts[0]
        assert triangles.any_launches > counts[1]
    else:
        assert bvh.launches >= counts[2] + 2


def _area_scene(tmp_path, device, **kw):
    path = ms.write_scene(str(tmp_path), "area", **kw)
    cam_spec, lights, shapes = load_scene_file(path)
    return path, compile_scene(shapes, lights, dtype=torch.float32,
                               device=device)


@pytest.mark.parametrize("spheres,level,n_origins", [
    (20, 1, 50000), (20, 3, 50000), (20, 5, 50000), (20, 7, 50000),
    (800, 2, 4096)])
def test_area_shadow_kernel_matches_plain_version(cuda, spheres, level,
                                                  n_origins, tmp_path):
    """B5 on 21 analytic prims (level 7: 49 samples, four chunks of the
    prim-major body), and on 801: past the 327 prims whose rows area.cu
    stages in shared memory it reads them from global memory. The same
    blocked count as the plain version on at least 99.99% of origins (an
    rsqrtf- or sqrtf-free predicate; the draws are integer-exact)."""
    _, scene = _area_scene(tmp_path, cuda, lat_lon=None, spheres=spheres,
                           reflective=0.3, area_level=level)
    rng = np.random.default_rng(level)
    pts = rng.uniform(-2.0, 2.0, (3, n_origins))
    pts[1] = np.abs(pts[1]) * 0.5
    over = tuple(torch.tensor(c, dtype=torch.float32, device=cuda)
                 for c in pts)
    light = scene.lights[0]
    args = (over, -12345, torch.cat([light.corner, light.uvec, light.vvec]),
            analytic.occlusion_params(scene, range(len(scene.prim_kinds))),
            scene.prim_kinds, level)
    assert len(scene.prim_kinds) == spheres + 1
    before = analytic.launches
    kern = analytic.area_shadow_fraction(*args)
    assert analytic.launches == before + 1
    plain = analytic.area_shadow_fraction_reference(*args)
    torch.cuda.synchronize()
    assert float((kern == plain).double().mean()) >= 0.9999
    assert 0.01 < float(plain.mean()) < 0.99


@pytest.mark.parametrize("name,kw", [
    ("area_light", None),
    ("area_mesh", dict(lat_lon=(11, 11), area_level=5)),
    ("area_reflective", dict(lat_lon=None, spheres=4, reflective=0.3,
                             area_level=3))])
def test_area_whitted_kernel_matches_plain_version(cuda, name, kw, tmp_path):
    """Stage c: area lights in the whitted kernel (with the mesh, and
    along the reflective chain with one seed per level)."""
    if kw is None:
        path = os.path.join(BASE, "examples", "area_light.yaml")
        cam_spec, lights, shapes = load_scene_file(path)
        scene = compile_scene(shapes, lights, dtype=torch.float32,
                              device=cuda)
    else:
        path, scene = _area_scene(tmp_path, cuda, **kw)
        cam_spec, _, _ = load_scene_file(path)
    cam = Camera(160, 120, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, cuda))
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings(), seed=3)
    assert any(inputs["light_levels"])
    kern = torch.stack(whitted.whitted_compact(*rays, **inputs))
    plain = torch.stack(whitted.whitted_compact_reference(*rays, **inputs))
    torch.cuda.synchronize()
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float((diff <= 1e-6).double().mean()) >= 0.999


def test_fast_node_launches_area_shadow_kernel(cuda, tmp_path):
    """21 analytic prims under an area light leave the whitted kernel for
    the fast node, whose shadows launch B5 on the main path."""
    path = ms.write_scene(str(tmp_path), "area21", lat_lon=None, spheres=20,
                          reflective=0.3, area_level=5)
    before = analytic.launches
    image = api.render_scene_from_file(path, 64, 48, "", device="cuda",
                                       seed=4)
    assert np.isfinite(image).all()
    assert analytic.launches > before


def _stage_e_scene(name, tmp_path, device):
    """(camera spec, scene) of config 5 (examples/csg_showcase.yaml), `csg5r`
    (config 5 with a perturbed stripe on the torus, a floor of
    reflective 0.3 and config 3's area light: stages c and e along the
    width-1 chain), or glass with a torus (stage e in the compact
    wavefront)."""
    if name == "csg":
        path = os.path.join(BASE, "examples", "csg_showcase.yaml")
    elif name == "csg5r":
        path = ms.write_config5(str(tmp_path), name, floor_reflective=0.3,
                                area_level=5, perturbed_torus=True)
    else:
        path = os.path.join(BASE, "examples", "glass.yaml")
    cam_spec, lights, shapes = load_scene_file(path)
    if name == "glass_torus":
        from rray_tpu_torch.scene.data import Shape
        shapes = shapes + [Shape("torus", minor_radius=0.3,
                                 material=shapes[1].material)]
    return cam_spec, compile_scene(shapes, lights, dtype=torch.float32,
                                   device=device)


@pytest.mark.parametrize("name", ["csg", "csg5r", "glass_torus"])
def test_stage_e_kernel_matches_plain_version(cuda, name, tmp_path):
    """Stage e (tori, CSG, noise, perturbed and image patterns) against
    the plain version, under chip_smoke.py's whitted budget: no ray over
    one u8 step and at most 0.1% over 1e-4 (the transcendentals are
    rounded doubles on both sides, and every division by a constant
    rounds once on both: vec.div)."""
    cam_spec, scene = _stage_e_scene(name, tmp_path, cuda)
    cam = Camera(160, 120, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, cuda))
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings(), seed=3)
    assert whitted.needs_ext(scene)
    before = whitted.launches
    kern = torch.stack(whitted.whitted_compact(*rays, **inputs))
    assert whitted.launches == before + 1
    plain = torch.stack(whitted.whitted_compact_reference(*rays, **inputs))
    torch.cuda.synchronize()
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float(diff.max()) <= 1.0 / 255.0
    assert float((diff > 1e-4).double().mean()) <= 1e-3


def test_fast_node_renders_textured_reflective_config5(cuda, tmp_path):
    """`tex5r`: config 5 with the CSG split into its operands and a
    reflective floor is textured and reflective, so the kernel rejects
    it and the torch fast node renders it."""
    from rray_tpu_torch.render import integrator
    path = ms.write_config5(str(tmp_path), "tex5r", floor_reflective=0.3,
                            split_csg=True)
    _, lights, shapes = load_scene_file(path)
    assert integrator.route(compile_scene(shapes, lights)) == "fast"
    image = api.render_scene_from_file(path, 64, 36, "", device="cuda")
    assert np.isfinite(image).all() and image.max() > 0.1


@pytest.mark.parametrize("name", ["glass4", "csgglass"])
def test_sorted_node_kernels_match_plain_versions(cuda, name, tmp_path):
    """The sorted torch node on the card: glass4 (a transparent 220-
    triangle mesh: the triangle kernels on the compact wavefront) and
    csgglass (config 5 with a transparent CSG operand: the hybrid CSG
    path) at 64x48 equal the same renders with the plain kernel versions
    (chip_smoke.py's plain_kernels and thresholds)."""
    import chip_smoke as cs
    from rray_tpu_torch.render import integrator
    if name in cs.SCENES:
        path = ms.write_scene(str(tmp_path), name, **cs.SCENES[name])
    else:
        path = ms.write_config5(str(tmp_path), name, **cs.CONFIG5[name])
    _, lights, shapes = load_scene_file(path)
    assert integrator.route(compile_scene(shapes, lights)) == "sorted"
    before = cs.launch_counts()
    image = api.render_scene_from_file(path, 64, 48, "", device="cuda")
    launched = {k: n - before[k] for k, n in cs.launch_counts().items()}
    if name == "glass4":
        assert launched["closest_triangle"] and launched["any_triangle"]
    with cs.plain_kernels():
        plain = api.render_scene_from_file(path, 64, 48, "", device="cuda")
    diff = np.abs(image - plain).max(-1)
    assert np.isfinite(image).all() and image.max() > 0.1
    assert diff.max() <= cs.MAX_TOL
    assert float((diff > cs.PIX_TOL).mean()) <= cs.FRAC_TOL


def _ragged_case(stage, tmp_path, device):
    """(camera spec, scene) of one stage of the whitted kernel: a (core:
    example1), c (area lights: config 3), d (the in-kernel mesh) and e
    (config 5: CSG, torus, noise, texture)."""
    if stage == "d":
        path = ms.write_scene(str(tmp_path), "mesh", lat_lon=(11, 11))
    else:
        path = os.path.join(BASE, "examples", {
            "a": "example1.yaml", "c": "area_light.yaml",
            "e": "csg_showcase.yaml"}[stage])
    cam_spec, lights, shapes = load_scene_file(path)
    return cam_spec, compile_scene(shapes, lights, dtype=torch.float32,
                                   device=device)


@pytest.mark.parametrize("stage", ["a", "c", "d", "e"])
@pytest.mark.parametrize("w,h", [(161, 97), (7, 5), (300, 1)])
def test_tiled_kernel_matches_plain_version(cuda, stage, w, h, tmp_path):
    """The tiled, persistent kernel (16x8 pixel tiles, given the raster
    width) at ragged raster sizes: every ray shaded once, at its own
    index, as the plain version shades it (stage c and e images equal
    bit for bit on the card at 800x600 and 1920x1080; the budget is
    test_stage_e_kernel_matches_plain_version's)."""
    cam_spec, scene = _ragged_case(stage, tmp_path, cuda)
    cam = Camera(w, h, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, cuda))
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings(), seed=3)
    before = whitted.launches
    kern = torch.stack(whitted.whitted_compact(*rays, **inputs, width=w))
    assert whitted.launches == before + 1
    rows = torch.stack(whitted.whitted_compact(*rays, **inputs))
    plain = torch.stack(whitted.whitted_compact_reference(*rays, **inputs))
    torch.cuda.synchronize()
    assert bool(torch.equal(kern, rows))
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float(diff.max()) <= 1.0 / 255.0
    assert float((diff > 1e-4).double().mean()) <= 1e-3


def test_blocks_per_sm_reports_occupancy(cuda):
    """The occupancy entry answers for every instantiation the wrapper
    launches, and more shared memory never raises the count."""
    for W, ext, KB in [(w, False, 0) for w in whitted.WIDTHS] + [
            (1, True, 8), (1, True, 80), (2, True, 0), (32, True, 0)]:
        small = whitted.blocks_per_sm(W, ext, KB, 0)
        big = whitted.blocks_per_sm(W, ext, KB, 100 * 1024)
        assert 1 <= big <= small <= 16


def test_progressive_area_frame_matches_plain_bands(cuda, monkeypatch):
    """Config 3 band by band on the card: one whitted launch per band,
    the scene's tables packed once for the frame, the frame within the
    main path's image thresholds (max |diff| <= 1/255, at most 0.1% of
    values past 1e-4) of the same bands through the plain version."""
    from rray_tpu_torch.render import progressive

    spec, lights, shapes = load_scene_file(
        os.path.join(BASE, "examples", "area_light.yaml"))
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=cuda)
    cam = Camera(160, 120, spec["fov"])
    cam.transform = spec["transform"]
    cam = compile_camera(cam, torch.float32, cuda)
    launches, builds = whitted.launches, whitted.table_builds
    got = progressive.ProgressiveRender(scene, cam, seed=3,
                                        band_rows=32).run()
    assert whitted.launches - launches == 4
    assert whitted.table_builds - builds == 1
    monkeypatch.setattr(
        whitted, "whitted_compact",
        lambda *a, width=None, **k: whitted.whitted_compact_reference(*a,
                                                                      **k))
    plain = progressive.ProgressiveRender(scene, cam, seed=3,
                                          band_rows=32).run()
    diff = np.abs(got - plain)
    assert np.isfinite(got).all() and got.max() > 0.1
    assert diff.max() <= 1.0 / 255.0
    assert float((diff > 1e-4).mean()) <= 1e-3


def test_profiling_trace_names_the_whitted_kernel(cuda, tmp_path):
    import glob

    from rray_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        api.render_scene_from_file(os.path.join(BASE, "examples",
                                                "glass.yaml"), 160, 120, "",
                                   device="cuda")
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert "whitted_kernel" in f.read()
    assert profiling.live_arrays_bytes() == torch.cuda.memory_allocated()


@pytest.mark.parametrize("name", ["glass.yaml", "mesh4", "csgglass"])
def test_aos_oracle_matches_routed_frame(cuda, name, tmp_path):
    """integrator.render_aos (rray_tpu's per-ray path) on the card at
    64x48 launches no kernel and holds the routed frame at full
    capacity within chip_smoke.py's oracle budget."""
    import dataclasses

    import chip_smoke as cs
    from rray_tpu_torch.render import integrator
    if name in cs.SCENES:
        path = ms.write_scene(str(tmp_path), name, **cs.SCENES[name])
    elif name in cs.CONFIG5:
        path = ms.write_config5(str(tmp_path), name, **cs.CONFIG5[name])
    else:
        path = os.path.join(BASE, "examples", name)
    cam_spec, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=cuda)
    cam = Camera(64, 48, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    settings = RenderSettings()
    settings = dataclasses.replace(settings,
                                   wavefront_capacity=2 ** settings.depth)
    before = cs.launch_counts()
    aos = integrator.render_aos(scene, compile_camera(cam, torch.float32,
                                                      cuda), settings)
    assert cs.launch_counts() == before
    routed = api.render_scene_from_file(path, 64, 48, "", settings=settings,
                                        device="cuda")
    diff = np.abs(aos.cpu().numpy() - routed)
    assert float((diff.max(-1) > cs.ORACLE_PIX).mean()) < cs.ORACLE_SHARE
    assert float(np.median(diff)) < cs.ORACLE_MEDIAN


def test_unrolled_launches_the_fast_kernels_not_whitted(cuda, tmp_path):
    """glass4 under wavefront "unrolled" on the card: the triangle
    kernels launch, the whitted kernel does not, and the frame is the
    "scan" frame within chip_smoke.py's bound."""
    import chip_smoke as cs
    path = ms.write_scene(str(tmp_path), "glass4", **cs.SCENES["glass4"])
    frames = {}
    for wavefront in ("unrolled", "scan"):
        before = cs.launch_counts()
        frames[wavefront] = api.render_scene_from_file(
            path, 64, 48, "", settings=RenderSettings(wavefront=wavefront),
            device="cuda")
        launched = {k: n - before[k] for k, n in cs.launch_counts().items()}
        assert launched["closest_triangle"] and launched["any_triangle"]
        assert not launched["whitted_compact"]
    assert np.abs(frames["unrolled"] - frames["scan"]).max() <= cs.UNROLLED_TOL


def _spread_raster(shape, dtype, seed):
    """Values over 20 decades of both signs with a few NaN and +-inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-10, 10, shape)
    x = x.astype(dtype)
    for value in (np.nan, np.inf, -np.inf):
        x.flat[rng.choice(x.size, 6, replace=False)] = value
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("aa", [2, 3, 4, 5, 7])
def test_downsample_kernel_matches_canvas_downsample(cuda, aa, dtype):
    """One launch, bit for bit canvas.downsample of the host raster and
    the plain version on the card; the rows and columns past the last
    whole block are cropped."""
    x = _spread_raster((37 * aa + aa - 1, 53 * aa + 1, 3), dtype, seed=aa)
    raster = torch.from_numpy(x).to(cuda)
    before = downsample.launches
    got = downsample.downsample(raster, aa)
    assert downsample.launches == before + 1
    assert got.device == raster.device and got.shape == (37, 53, 3)
    torch.cuda.synchronize()
    want = canvas.downsample(x, aa)
    assert got.dtype == raster.dtype
    assert np.array_equal(got.cpu().numpy(), want, equal_nan=True)
    plain = downsample.downsample_reference(raster, aa).cpu().numpy()
    assert np.array_equal(plain, want, equal_nan=True)


def test_downsample_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    raster = torch.zeros((8, 12, 3), device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        downsample.downsample(raster.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        downsample.downsample(raster[:, ::2], 2)
    with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
        downsample.downsample(raster[..., :2].contiguous(), 2)


@pytest.mark.parametrize("name,size,aa", [("glass.yaml", (160, 120), 2),
                                          ("csg_showcase.yaml", (192, 108),
                                           5)])
def test_render_scene_downsamples_on_the_card(cuda, name, size, aa,
                                               tmp_path):
    """api.render_scene at aa > 1: one downsample launch, and the image
    canvas.downsample makes of the copied raster, bit for bit, so the PNG
    bytes are the same."""
    spec, lights, shapes = load_scene_file(os.path.join(BASE, "examples",
                                                        name))
    w, h = size
    before = downsample.launches
    image = api.render_scene(spec, lights, shapes, w, h, aa, device="cuda")
    assert downsample.launches == before + 1
    scene, cam = api._build(spec, lights, shapes, w, h, aa, torch.float32,
                            cuda)
    raster = render(scene, cam, RenderSettings(), 0).cpu().numpy()
    host = canvas.downsample(raster, aa)
    assert image.dtype == host.dtype and image.max() > 0.1
    assert np.array_equal(image, host, equal_nan=True)
    canvas.write_png(str(tmp_path / "card.png"), image)
    canvas.write_png(str(tmp_path / "host.png"), host)
    assert ((tmp_path / "card.png").read_bytes()
            == (tmp_path / "host.png").read_bytes())


def test_cli_frame_launches_the_downsample_once_at_aa_over_one(cuda,
                                                               tmp_path):
    glass = os.path.join(BASE, "examples", "glass.yaml")
    for aa, launched in ((1, 0), (2, 1), (3, 1), (1, 0)):
        before = downsample.launches
        image = api.render_scene_from_file(glass, 64, 48,
                                           str(tmp_path / "a.png"), aa=aa,
                                           device="cuda")
        assert downsample.launches - before == launched
        assert image.shape == (48, 64, 3)
