"""Gradients of a render loss through each of the port's routes against
rray_tpu's jax.grad (pallas off), leaf by leaf by key path, in float64
at torch_grad_parity.GRAD_TOL (1e-9 x max(1, |g|)): the whitted kernel's
route (integrator.WhittedKernel, whose backward recomputes the torch
nodes), the fast node (analytic prims, a nine-mesh scene through the
closest-triangle Function on the chunk kernel's and the BVH kernel's
plain versions) and the sorted node (a transparent mesh, config 5 with a
transparent CSG operand). The scenes are the in-repo YAML and
rray_tpu_torch/io/mesh_scenes.py's, at 16x12."""
import os

import pytest

from rray_tpu import RenderSettings as JaxSettings
from rray_tpu.io.yaml_loader import load_scene_file as jax_load
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.render import integrator
from torch_grad_parity import assert_grads_match, jax_grads, pair, port_grads

# name: (route, scene writer, settings)
CASES = {
    "example1": ("kernel", lambda tmp: os.path.join(ms.EXAMPLES,
                                                    "example1.yaml"), {}),
    "glass": ("kernel", lambda tmp: os.path.join(ms.EXAMPLES, "glass.yaml"),
              {}),
    "area_light": ("kernel", lambda tmp: os.path.join(
        ms.EXAMPLES, "area_light.yaml"), {}),
    "mesh4": ("kernel", lambda tmp: ms.write_scene(tmp, "mesh4",
                                                   lat_lon=(11, 11)), {}),
    "mesh9": ("fast", lambda tmp: ms.write_scene(tmp, "mesh9", lat_lon=(3, 4),
                                                 grid=True), {}),
    "mesh9_bvh": ("fast", lambda tmp: ms.write_scene(
        tmp, "mesh9", lat_lon=(3, 4), grid=True), dict(bvh_min_tris=64)),
    "spheres17": ("fast", lambda tmp: ms.write_scene(
        tmp, "spheres17", lat_lon=None, spheres=17, reflective=0.3), {}),
    "glassmesh": ("sorted", lambda tmp: ms.write_scene(
        tmp, "glassmesh", lat_lon=(3, 4), glass=True), {}),
    "csgglass": ("sorted", lambda tmp: ms.write_config5(
        tmp, "csgglass", transparent_operand=0.5), dict(depth=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_route_gradients_match_rray_tpu(name, tmp_path):
    want_route, write, kw = CASES[name]
    spec, lights, shapes = jax_load(write(str(tmp_path)))
    (jscene, jcam), (scene, cam) = pair(shapes, lights, 16, 12, spec["fov"],
                                        spec["transform"])
    assert integrator.route(scene) == want_route
    want = jax_grads(jscene, jcam, JaxSettings(**kw))
    assert sum(1 for v in want.values() if v.size and abs(v).max() > 0) > 5
    assert_grads_match(port_grads(scene, cam, RenderSettings(**kw)), want)
