"""Mesh scenes through the port's main path on the CPU, against
rray_tpu: the torch fast node (meshes the whitted kernel rejects, and
analytic scenes of more than 16 prims) against rray_tpu's
`_color_at_soa_xla` with pallas off, the whitted plain version with its
in-kernel mesh against rray_tpu's kernel-free XLA node, both in float64
at atol 1e-9 (the same formulas on the same tables; only the order of a
few sums differs, measured < 1e-13), end-to-end renders with identical
8-bit images, the CLI, the routing, and the host library's build
place."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rray_tpu.api as jax_api
import rray_tpu.io.yaml_loader as jax_yaml
import torch_mesh_parity as mp
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu.ops.vec import V3 as JV3
from rray_tpu.render import integrator as jax_integrator
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.render import canvas, integrator
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Three fast-node scenes: a 1104-triangle mesh (the BVH
# kernel's path) over a reflective floor at depth 2, nine material
# groups (the linear triangle kernels), 17 analytic spheres.
FAST = {"bvh_reflective": (dict(lat_lon=(24, 24), reflective=0.3), 2),
        "nine_groups": (dict(lat_lon=(6, 6), grid=True), 5),
        "spheres17": (dict(lat_lon=None, spheres=17), 5)}


def _jax_rays(o, d):
    return JV3(*(jnp.asarray(c) for c in o)), JV3(*(jnp.asarray(c) for c in d))


def _port_rays(o, d):
    return V3(*(torch.from_numpy(c) for c in o)), \
        V3(*(torch.from_numpy(c) for c in d))


@pytest.mark.parametrize("name", list(FAST))
def test_fast_node_matches_xla_f64(name, tmp_path):
    kw, depth = FAST[name]
    path, jscene, tscene = mp.scenes(tmp_path, name, "float64", **kw)
    assert integrator.route(tscene) == "fast"
    o, d = mp.camera_rays(path, 32, 24, "float64")
    ref = jax_integrator._color_at_soa_xla(
        jscene, *_jax_rays(o, d), depth, JaxSettings(pallas="off",
                                                     depth=depth),
        jax.random.PRNGKey(0))
    out = integrator.color_at_fast(
        tscene, *_port_rays(o, d), depth, RenderSettings(depth=depth),
        jitter.seed_table(0, depth, len(tscene.lights)))
    for a, b in zip((out.x, out.y, out.z), (ref.x, ref.y, ref.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    assert float(out.x.abs().max()) > 0.1


@pytest.mark.parametrize("reflective", [0.0, 0.3])
def test_whitted_mesh_plain_matches_xla_f64(reflective, tmp_path):
    path, jscene, tscene = mp.scenes(tmp_path, "kernel", "float64",
                                     lat_lon=(11, 11), reflective=reflective)
    assert integrator.route(tscene) == "kernel"
    o, d = mp.camera_rays(path, 32, 24, "float64")
    inputs = whitted.kernel_inputs(tscene, RenderSettings())
    port = whitted.whitted_compact(*(tuple(torch.from_numpy(c) for c in x)
                                     for x in (o, d)), **inputs)
    ref = jax_integrator._xla_reference_node(
        jscene, *_jax_rays(o, d), 5, JaxSettings(pallas="off"),
        jax.random.PRNGKey(0))
    for a, b in zip(port, (ref.x, ref.y, ref.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("name,kw", [
    ("kernel_path", dict(lat_lon=(6, 6), reflective=0.3)),
    ("fast_path", dict(lat_lon=(3, 4), grid=True))])
def test_render_scene_from_file_matches_rray_tpu_f64(name, kw, tmp_path):
    path = ms.write_scene(str(tmp_path), name, **kw)
    want = np.asarray(jax_api.render_scene_from_file(
        path, 48, 36, str(tmp_path / "a.png"), dtype=jnp.float64))
    got = api.render_scene_from_file(path, 48, 36, str(tmp_path / "b.png"),
                                     dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(canvas.to_u8(got), canvas.to_u8(want))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


def test_routing(tmp_path):
    def scene(name, **kw):
        _, lights, shapes = load_scene_file(
            ms.write_scene(str(tmp_path), name, **kw))
        return compile_scene(shapes, lights, device="cpu")

    assert integrator.route(scene("small", lat_lon=(11, 11))) == "kernel"
    big = scene("big", lat_lon=(24, 24))
    assert big.counts[6] == 1104 and integrator.route(big) == "fast"
    nine = scene("nine", lat_lon=(3, 4), grid=True)
    assert "8 material groups" in whitted.unsupported(nine)
    assert integrator.route(nine) == "fast"
    # A transparent mesh: the sorted node, which renders it as rray_tpu
    # does (float64, atol 1e-9).
    path = ms.write_scene(str(tmp_path), "glassy", lat_lon=(3, 4))
    _, lights, shapes = load_scene_file(path)
    shapes[1].children[0].material.transparency = 0.5
    scene = compile_scene(shapes, lights, device="cpu")
    assert integrator.route(scene) == "sorted"
    cam_spec, jlights, jshapes = jax_yaml.load_scene_file(path)
    jshapes[1].children[0].material.transparency = 0.5
    want = np.asarray(jax_api.render_scene(cam_spec, jlights, jshapes, 8, 6,
                                           dtype=jnp.float64))
    got = api.render_scene(cam_spec, lights, shapes, 8, 6,
                           dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_cli_renders_a_mesh_and_leaves_native_unchanged(tmp_path):
    """The CLI on the CPU renders an OBJ scene; the port builds its host
    library into build/rray_tpu_torch/ and writes nothing into native/
    (run from a copy of the package and the native source, so the check
    sees only this process)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(BASE, "rray_tpu_torch"),
                    root / "rray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "native").mkdir()
    shutil.copy(os.path.join(BASE, "native", "rray_host.cpp"),
                root / "native")
    scene = ms.write_scene(str(tmp_path), "cli", lat_lon=(6, 6))
    out = tmp_path / "out.png"
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("RRAY_NO_NATIVE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "rray_tpu_torch.cli", "-W", "32", "-H", "24",
         "-s", scene, "-o", str(out), "--device", "cpu"],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert np.asarray(Image.open(out)).shape == (24, 32, 4)
    assert sorted(os.listdir(root / "native")) == ["rray_host.cpp"]
    if shutil.which("g++"):
        built = os.listdir(root / "build" / "rray_tpu_torch")
        assert [f for f in built if f.startswith("librray_host_")], built
