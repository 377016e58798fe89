"""Config 5 (examples/csg_showcase.yaml: CSG, torus, Perlin noise, an
image texture) through the port's main path on the CPU, against
rray_tpu: `render_scene_from_file` in float64 with the same 8-bit image
and the same PNG bytes; and `tex5r` (config 5 with the CSG split into
its operands and a reflective floor: textured and reflective, which the
whitted kernel rejects) through the torch fast node against rray_tpu's
`_color_at_soa_xla` in float64 at atol 1e-9, under a point light and
under config 3's area light (a torus scene's shadows take the sample
loop, as the area-shadow kernel takes no tori)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.api as jax_api
import rray_tpu.io.yaml_loader as jax_yaml
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_scene
from rray_tpu.ops.vec import V3 as JV3
from rray_tpu.render import integrator as jax_integrator
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import analytic, whitted
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.render import camera, canvas, integrator
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from rray_tpu_torch.scene.data import compile_scene as port_compile

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSG = os.path.join(BASE, "examples", "csg_showcase.yaml")


def test_render_scene_from_file_matches_rray_tpu_f64(tmp_path):
    """48x27 at aa=2 (a 96x54 raster) through the whitted kernel's plain
    version with stage e."""
    want = np.asarray(jax_api.render_scene_from_file(
        CSG, 48, 27, str(tmp_path / "a.png"), aa=2, dtype=jnp.float64))
    got = api.render_scene_from_file(CSG, 48, 27, str(tmp_path / "b.png"),
                                     aa=2, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(canvas.to_u8(got), canvas.to_u8(want))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
    assert got.max() > 0.5


@pytest.mark.parametrize("area_level", [0, 2])
def test_fast_node_tex5r_matches_xla_f64(area_level, tmp_path, monkeypatch):
    path = ms.write_config5(str(tmp_path), "tex5r", floor_reflective=0.3,
                            area_level=area_level, split_csg=True)
    _, lights, shapes = jax_yaml.load_scene_file(path)
    jscene = compile_scene(shapes, lights, dtype=jnp.float64)
    tscene = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    assert not tscene.csg_ops and integrator.route(tscene) == "fast"
    assert "reflection" in whitted.unsupported(tscene)
    cam_spec, _, _ = jax_yaml.load_scene_file(path)
    cam = camera.Camera(32, 18, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = camera.all_rays_soa(camera.compile_camera(cam, torch.float64,
                                                        "cpu"))
    depth = 5
    ref = jax_integrator._color_at_soa_xla(
        jscene, JV3(*(jnp.asarray(c.numpy()) for c in (ro.x, ro.y, ro.z))),
        JV3(*(jnp.asarray(c.numpy()) for c in (rd.x, rd.y, rd.z))), depth,
        JaxSettings(pallas="off", depth=depth), jax.random.PRNGKey(7))
    monkeypatch.setattr(analytic, "area_shadow_fraction",
                        lambda *a: pytest.fail("B5 takes no tori"))
    out = integrator.color_at_fast(
        tscene, V3(ro.x, ro.y, ro.z), V3(rd.x, rd.y, rd.z), depth,
        RenderSettings(depth=depth),
        jitter.seed_table(7, depth, len(tscene.lights)))
    for a, b in zip((out.x, out.y, out.z), (ref.x, ref.y, ref.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    assert float(out.x.max()) > 0.3


def test_config5_routes(tmp_path):
    """Config 5 and its variants pick the node rray_tpu's gate picks:
    the kernel for config 5 (depth 0, one image per tree) and for a
    reflective variant without the image; the fast node for a textured
    reflective scene without CSG; the sorted torch node for a CSG that
    the kernel rejects (textured and reflective), which renders it as
    rray_tpu does (float64, atol 1e-9)."""
    tmp = str(tmp_path)
    cases = {CSG: "kernel",
             ms.write_config5(tmp, "csg5r", floor_reflective=0.3,
                              perturbed_torus=True): "kernel",
             ms.write_config5(tmp, "tex5r", floor_reflective=0.3,
                              split_csg=True): "fast"}
    for path, want in cases.items():
        _, lights, shapes = load_scene_file(path)
        scene = port_compile(shapes, lights, device="cpu")
        assert integrator.route(scene) == want
    # A textured reflective scene WITH a CSG: the sorted node.
    path = ms.write_config5(tmp, "csg_tex_refl", floor_reflective=0.3)
    _, lights, shapes = load_scene_file(path)
    scene = port_compile(shapes, lights, device="cpu")
    assert integrator.route(scene) == "sorted"
    # 10x8: at 8x6 and at odd heights a config 5 pixel lands on a
    # checker edge of the floor, where rounding picks the square (and
    # rray_tpu's compiled frame differs from its own scan).
    want = np.asarray(jax_api.render_scene_from_file(path, 10, 8, "",
                                                     dtype=jnp.float64))
    got = api.render_scene_from_file(path, 10, 8, "", dtype=torch.float64,
                                     device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
