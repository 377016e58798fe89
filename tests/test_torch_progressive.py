"""Progressive, checkpointed and resilient rendering in the port
(rray_tpu_torch.render.progressive, api.render_scene_progressive,
api.render_resilient, the CLI's --checkpoint/--band-rows) on the CPU,
and the band keys that make a banded area-light frame rray_tpu's.

rray_tpu keys the band of rows [r0, r0 + n) on fold_in(PRNGKey(seed),
r0) (render/progressive.py render_rows), so an area-light frame built
from bands differs from the one-shot frame; the port's bands must equal
rray_tpu's bands on each route (float64, atol 1e-9), and a port that
keyed its bands on PRNGKey(seed) fails that comparison. Checkpoints are
rray_tpu's npz, readable by either package."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rray_tpu
from rray_tpu import (AreaLight, Material, Pattern, PointLight, Shape,
                      compile_scene)
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import mathutils as mu
from rray_tpu.io.yaml_loader import load_scene_file as jax_load_scene_file
from rray_tpu.render import integrator as jax_integrator
from rray_tpu.render import progressive as jax_progressive
import rray_tpu_torch
from rray_tpu_torch import api, cli
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render import canvas, integrator, progressive
from rray_tpu_torch.render.camera import Camera, compile_camera
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from torch_grad_parity import pair

VIEW = mu.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0])
FLOOR = Shape("plane", material=Material(
    pattern=Pattern("checker", a=Pattern.solid([1.0, 1.0, 1.0]),
                    b=Pattern.solid([0.2, 0.2, 0.2])), specular=0.0))
BALL = Shape("sphere", transform=mu.translate(0, 1, 0),
             material=Material(pattern=Pattern.solid([0.7, 0.2, 0.2])))
AREA = AreaLight(np.array([-3.0, 5.0, -3.0]), np.array([2.0, 0.0, 0.0]),
                 np.array([0.0, 0.0, 2.0]), np.ones(3), level=3)
POINT = PointLight(np.array([-10.0, 10.0, -10.0]), np.ones(3))
SEED = 5
SCENE_YAML = """
camera:
  fov: 60
  from: [0, 1.5, -5.0]
  to: [0, 1, 0]
  up: [0, 1, 0]
lights:
  - type: point
    color: [1, 1, 1]
    position: [-10, 10, -10]
scene:
  - type: sphere
    transforms:
      - type: translate
        amount: [0, 1, 0]
    material:
      pattern:
        type: solid
        color: [0.7, 0.2, 0.2]
  - type: plane
    material:
      pattern:
        type: checker
        color_a: [1, 1, 1]
        color_b: [0.2, 0.2, 0.2]
      specular: 0
"""


@pytest.fixture(autouse=True)
def jax_bands(monkeypatch):
    """rray_tpu's render_rows jitted with row_start traced (rray_tpu
    makes it static, one compile per band): the same function and
    values, one compile per band height."""
    monkeypatch.setattr(jax_progressive, "_render_rows_jit", _JAX_ROWS)


_JAX_ROWS = jax.jit(jax_progressive.render_rows,
                    static_argnames=("n_rows", "settings", "seed"))
_JAX_COLOR_AT = jax.jit(jax_integrator.color_at,
                        static_argnames=("remaining", "settings"))


# 28 rows: bands of 4 and of 7 rows are whole, one band height each (one
# rray_tpu compile each).
WIDTH, HEIGHT = 16, 28


def _area_pair():
    """The sphere over a checker floor under a level-3 area light, in
    both packages (whitted kernel route)."""
    return pair([FLOOR, BALL], [AREA], WIDTH, HEIGHT, np.pi / 3, VIEW)


def _mesh_pair(tmp_path):
    """Nine tetrahedron-grid meshes of nine colours under config 3's
    area light at level 2 (the fast node: nine material groups)."""
    spec, lights, shapes = jax_load_scene_file(ms.write_scene(
        str(tmp_path), "nine", lat_lon=(3, 4), grid=True, area_level=2))
    return _compiled(compile_scene(shapes, lights, dtype=jnp.float64),
                     spec, WIDTH, HEIGHT)


def _sorted_pair():
    """A glass sphere (refraction alone), a CSG (cube minus sphere) and
    a checker floor under a real-extent area light (the sorted node)."""
    glass = Shape("sphere", transform=mu.translate(-0.8, 1, 0.2),
                  material=Material(pattern=Pattern.solid([0.05] * 3),
                                    transparency=0.9, refractive_index=1.5,
                                    diffuse=0.1))
    cube = Shape("cube", transform=mu.compose(
        [mu.translate(1.6, 0.5, 0.5), mu.scale(0.5, 0.5, 0.5)]),
        material=Material(pattern=Pattern.solid([0.8, 0.3, 0.3])))
    ball = Shape("sphere", transform=mu.compose(
        [mu.translate(1.9, 0.9, 0.2), mu.scale(0.45, 0.45, 0.45)]),
        material=Material(pattern=Pattern.solid([0.2, 0.6, 0.3])))
    csg = Shape("csg", operation="difference", left=cube, right=ball)
    light = AreaLight(np.array([5.0, 6.0, -5.0]), np.array([1.5, 0.0, 0.0]),
                      np.array([0.0, 1.5, 0.0]), np.full(3, 0.9), level=2)
    return pair([FLOOR, glass, csg], [light], WIDTH, HEIGHT, np.pi / 3,
                mu.view_transform([0, 1.8, -4.5], [0.4, 0.8, 0], [0, 1, 0]))


def _compiled(jscene, spec, width, height):
    from rray_tpu import Camera as JaxCamera, compile_camera as jcompile

    jcam = JaxCamera(width, height, spec["fov"])
    jcam.transform = spec["transform"]
    cam = Camera(width, height, spec["fov"])
    cam.transform = spec["transform"]
    return ((jscene, jcompile(jcam, jnp.float64)),
            (scene_from_numpy(*scene_to_numpy(jscene), device="cpu"),
             compile_camera(cam, torch.float64, "cpu")))


@pytest.mark.parametrize("band_rows", [4, 7])
@pytest.mark.parametrize("node", ["kernel", "fast", "sorted"])
def test_progressive_matches_rray_tpu(node, band_rows, tmp_path):
    """The port's ProgressiveRender against rray_tpu's on an area-light
    scene, float64, atol 1e-9, on each route (the kernel route through
    the whitted kernel's plain version, the fast node with a mesh, the
    sorted node with glass and a CSG); the banded frame is not the
    one-shot frame, so bands keyed on PRNGKey(seed) would fail."""
    (jscene, jcam), (scene, cam) = {
        "kernel": _area_pair, "fast": lambda: _mesh_pair(tmp_path),
        "sorted": _sorted_pair}[node]()
    assert integrator.route(scene) == node
    want = jax_progressive.ProgressiveRender(
        jscene, jcam, JaxSettings(), seed=SEED, band_rows=band_rows).run()
    got = progressive.ProgressiveRender(scene, cam, RenderSettings(), SEED,
                                        band_rows).run()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    with torch.no_grad():
        one_shot = integrator.render(scene, cam, RenderSettings(),
                                     SEED).numpy()
    assert np.abs(got - one_shot).max() > 1e-3


def test_bands_match_one_shot_point_light():
    """A point light draws no jitter: the bands are the one-shot frame
    (rray_tpu's test_bands_match_one_shot), each band within 1e-12."""
    _, (scene, cam) = pair([FLOOR, BALL], [POINT], 32, 24, np.pi / 3, VIEW)
    settings = RenderSettings(rows_per_tile=16)
    with torch.no_grad():
        one_shot = integrator.render(scene, cam, settings).numpy()
        for r0 in range(0, 24, 7):
            n = min(7, 24 - r0)
            band = progressive.render_rows(scene, cam, r0, n, settings)
            np.testing.assert_allclose(band.numpy(), one_shot[r0:r0 + n],
                                       rtol=0, atol=1e-12)
    out = progressive.ProgressiveRender(scene, cam, settings,
                                        band_rows=7).run()
    np.testing.assert_allclose(out, one_shot.astype(np.float32), rtol=0,
                               atol=1e-12)


def test_resume_renders_only_unfinished_bands(tmp_path, monkeypatch):
    _, (scene, cam) = _area_pair()
    path = str(tmp_path / "ckpt.npz")
    calls = []
    render_rows = progressive.render_rows

    def counted(scene, cam, row_start, n_rows, *args):
        calls.append(row_start)
        return render_rows(scene, cam, row_start, n_rows, *args)

    monkeypatch.setattr(progressive, "render_rows", counted)
    builds = whitted.table_builds
    prog = progressive.ProgressiveRender(scene, cam, seed=SEED, band_rows=4,
                                         checkpoint_path=path)
    prog.run(bands=[0, 2])
    assert calls == [0, 8]
    resumed = progressive.ProgressiveRender.resume(path, scene, cam,
                                                   seed=SEED)
    assert resumed.done.tolist() == [True, False, True] + [False] * 4
    out = resumed.run()
    assert calls == [0, 8, 4, 12, 16, 20, 24] and resumed.done.all()
    # The whitted tables are packed once for the scene, not per band.
    assert whitted.table_builds == builds + 1
    full = progressive.ProgressiveRender(scene, cam, seed=SEED,
                                         band_rows=4).run()
    np.testing.assert_array_equal(out, full)


@pytest.mark.parametrize("writer", ["rray_tpu", "port"])
def test_checkpoints_interchange(writer, tmp_path):
    """A checkpoint written by one package resumes in the other: the
    same npz keys, the bands keyed alike, so the finished frame equals
    rray_tpu's uninterrupted banded frame."""
    (jscene, jcam), (scene, cam) = _area_pair()
    path = str(tmp_path / "ckpt.npz")
    first, second = ((jax_progressive.ProgressiveRender,
                      progressive.ProgressiveRender) if writer == "rray_tpu"
                     else (progressive.ProgressiveRender,
                           jax_progressive.ProgressiveRender))
    args = {jax_progressive.ProgressiveRender: (jscene, jcam, JaxSettings()),
            progressive.ProgressiveRender: (scene, cam, RenderSettings())}
    first(*args[first], seed=SEED, band_rows=4,
          checkpoint_path=path).run(bands=[1])
    with np.load(path) as state:
        assert sorted(state.files) == ["band_rows", "canvas", "done"]
        assert state["canvas"].dtype == np.float32
        assert state["done"].tolist() == [False, True] + [False] * 5
    resumed = second.resume(path, *args[second], seed=SEED)
    out = resumed.run()
    want = jax_progressive.ProgressiveRender(
        jscene, jcam, JaxSettings(), seed=SEED, band_rows=4).run()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-9)


def test_truncated_checkpoint_starts_fresh(tmp_path, caplog):
    scene_yaml = tmp_path / "scene.yaml"
    scene_yaml.write_text(SCENE_YAML)
    ckpt = tmp_path / "frame.npz"
    ckpt.write_bytes(b"PK\x03\x04 truncated")
    with caplog.at_level(logging.WARNING, logger="rray_tpu_torch"):
        image = api.render_scene_progressive(
            str(scene_yaml), 16, 12, "", band_rows=5,
            checkpoint_path=str(ckpt), device="cpu")
    assert "starting fresh" in caplog.text
    want = api.render_scene_from_file(str(scene_yaml), 16, 12, "",
                                      device="cpu")
    np.testing.assert_array_equal(image, want)
    with np.load(ckpt) as state:
        assert state["done"].all()


def test_render_resilient_survives_injected_failures(tmp_path, monkeypatch):
    """rray_tpu's test_elastic_render_survives_crashes on the port's
    CLI: every child dies after two bands; the retries resume from the
    band checkpoint and the PNG matches a direct render."""
    scene_yaml = tmp_path / "scene.yaml"
    scene_yaml.write_text(SCENE_YAML)
    png = str(tmp_path / "out.png")
    ckpt = str(tmp_path / "frame.npz")
    monkeypatch.setenv("RRAY_FAIL_AFTER_BANDS", "2")
    rc = api.render_resilient(str(scene_yaml), 32, 24, png, band_rows=8,
                              checkpoint_path=ckpt, attempts=4, device="cpu")
    assert rc == 0
    with np.load(ckpt) as state:
        assert state["done"].all()
    got = np.asarray(Image.open(png).convert("RGB"), np.int32)
    want = canvas.to_u8(api.render_scene_from_file(
        str(scene_yaml), 32, 24, "", device="cpu")).astype(np.int32)
    assert np.abs(got - want).max() <= 1


def test_cli_parses_checkpoint_options():
    args = cli.build_parser().parse_args(
        ["-s", "x.yaml", "--checkpoint", "f.npz", "--band-rows", "16"])
    assert (args.checkpoint, args.band_rows, args.device) == (
        "f.npz", 16, "cuda")
    args = cli.build_parser().parse_args(["-s", "x.yaml"])
    assert (args.checkpoint, args.band_rows) == (None, 64)


@pytest.mark.parametrize("node", ["kernel", "sorted"])
def test_color_at_matches_rray_tpu(node):
    """integrator.color_at, rray_tpu's public [R, 3] entry, under an int
    seed and under a band's root key, against rray_tpu's color_at with
    the same keys (float64, atol 1e-9)."""
    (jscene, jcam), (scene, cam) = (_area_pair() if node == "kernel"
                                    else _sorted_pair())
    rng = np.random.default_rng(0)
    o = np.array([0.0, 1.5, -5.0]) + rng.normal(0, 0.1, (64, 3))
    d = np.array([0.0, 0.8, 0.0]) + rng.normal(0, 1.0, (64, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for key, jkey in ((SEED, jax.random.PRNGKey(SEED)),
                      (progressive.band_key(SEED, 8),
                       jax.random.fold_in(jax.random.PRNGKey(SEED), 8))):
        want = np.asarray(_JAX_COLOR_AT(
            jscene, jnp.asarray(o), jnp.asarray(d), 3,
            JaxSettings(pallas="off"), jkey))
        with torch.no_grad():
            got = integrator.color_at(scene, torch.from_numpy(o),
                                      torch.from_numpy(d), 3,
                                      RenderSettings(), key)
        assert got.shape == (64, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_top_level_exports_cover_rray_tpu():
    assert set(rray_tpu.__all__) <= set(rray_tpu_torch.__all__)
    for name in rray_tpu_torch.__all__:
        assert getattr(rray_tpu_torch, name) is not None
    assert rray_tpu_torch.render_scene_from_file is api.render_scene_from_file
    assert rray_tpu_torch.glass_material().transparency == 1.0
    assert rray_tpu_torch.default_dtype() == torch.float32
