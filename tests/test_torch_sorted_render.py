"""Scenes of the sorted torch node through the port's main path on the
CPU, against rray_tpu: `render_scene_from_file` at 16x12 in float64 at
atol 1e-9, for a transparent 16-triangle mesh, config 5 with a
transparent CSG operand (csgglass) and with a tetrahedron as its operand
(csgmesh), config 5 textured over a reflective floor (csg_tex_refl: a
CSG the whitted kernel rejects for its texture beyond depth 0), and 17
spheres, half of them glass, at depth 2; and the routes of a few
scenes, glass with a `test` pattern (10x8) among them."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.api as jax_api
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.render import integrator
from rray_tpu_torch.scene.data import compile_scene

CASES = {
    "glassmesh": (lambda tmp: ms.write_scene(tmp, "glassmesh", lat_lon=(3, 4),
                                             glass=True), 5),
    "csgglass": (lambda tmp: ms.write_config5(tmp, "csgglass",
                                              transparent_operand=0.5), 5),
    "csgmesh": (lambda tmp: ms.write_config5(tmp, "csgmesh",
                                             mesh_operand=True), 5),
    "csg_tex_refl": (lambda tmp: ms.write_config5(
        tmp, "csg_tex_refl", floor_reflective=0.3), 5),
    "glass17": (lambda tmp: ms.write_scene(tmp, "glass17", lat_lon=None,
                                           spheres=17, glass=True), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_rray_tpu_f64(name, tmp_path):
    write, depth = CASES[name]
    path = write(str(tmp_path))
    _, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, device="cpu")
    assert integrator.route(scene) == "sorted"
    want = np.asarray(jax_api.render_scene_from_file(
        path, 16, 12, "", dtype=jnp.float64,
        settings=JaxSettings(depth=depth)))
    got = api.render_scene_from_file(path, 16, 12, "", dtype=torch.float64,
                                     settings=RenderSettings(depth=depth),
                                     device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert got.max() > 0.3


def test_routes_and_a_transparent_test_pattern(tmp_path):
    """route(): glass takes the whitted kernel; glass with a `test`
    pattern on its floor (a pattern the kernel rejects) and 17 spheres
    half of glass take the sorted node, which renders the first as
    rray_tpu does; 17 opaque spheres take the fast node."""
    from rray_tpu.io.yaml_loader import load_scene_file as jax_load
    from rray_tpu_torch.scene.data import Pattern

    glass = os.path.join(ms.EXAMPLES, "glass.yaml")
    _, lights, shapes = load_scene_file(glass)
    scene = compile_scene(shapes, lights, device="cpu")
    assert integrator.route(scene) == "kernel"
    shapes[0].material.pattern = Pattern("test")
    scene = compile_scene(shapes, lights, device="cpu")
    assert integrator.route(scene) == "sorted"
    cam_spec, jlights, jshapes = jax_load(glass)
    jshapes[0].material.pattern = type(jshapes[0].material.pattern)("test")
    want = np.asarray(jax_api.render_scene(cam_spec, jlights, jshapes, 10, 8,
                                           dtype=jnp.float64))
    got = api.render_scene(cam_spec, lights, shapes, 10, 8,
                           dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for glassy, node in ((True, "sorted"), (False, "fast")):
        _, lights, shapes = load_scene_file(ms.write_scene(
            str(tmp_path), f"s17{glassy}", lat_lon=None, spheres=17,
            glass=glassy))
        assert integrator.route(compile_scene(shapes, lights,
                                               device="cpu")) == node
