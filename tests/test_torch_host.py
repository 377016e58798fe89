"""rray_tpu_torch's host layer against rray_tpu's: YAML loading, scene
compilation, kernel table packing, camera rays, PNG output, and the
numpy hand-over of a compiled scene (scene/convert.py). All exact,
except camera rays (f64, atol 1e-12: the same formula evaluated by two
libraries)."""
import dataclasses
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.io.yaml_loader as jax_yaml
import rray_tpu_torch.io.yaml_loader as torch_yaml
from rray_tpu import compile_scene as jax_compile_scene
from rray_tpu.kernels import whitted as jax_whitted
from rray_tpu.render import camera as jax_camera
from rray_tpu.render import canvas as jax_canvas
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render import camera, canvas
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(BASE, "examples", "*.yaml")))
SLICE = [os.path.join(BASE, "examples", n)
         for n in ("example1.yaml", "glass.yaml")]


def _assert_same(a, b, where="root"):
    """Recursive equality of loader output: dataclasses by class name and
    fields, arrays exactly, floats exactly (NaN == NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


def _assert_tree_equal(a, b, where="root"):
    """Equality of (fields, meta) trees from scene_to_numpy, dtype
    included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, f"{where}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, where)
    else:
        assert a == b, where


def _compile_both(path, jdtype, tdtype):
    _, lights, shapes = jax_yaml.load_scene_file(path)
    _, t_lights, t_shapes = torch_yaml.load_scene_file(path)
    return (jax_compile_scene(shapes, lights, dtype=jdtype),
            compile_scene(t_shapes, t_lights, dtype=tdtype, device="cpu"))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_loader_matches_rray_tpu(path):
    _assert_same(jax_yaml.load_scene_file(path),
                 torch_yaml.load_scene_file(path))


@pytest.mark.parametrize("path", SLICE, ids=os.path.basename)
def test_compile_scene_tables_match_f64(path):
    jscene, tscene = _compile_both(path, jnp.float64, torch.float64)
    _assert_tree_equal(scene_to_numpy(jscene), scene_to_numpy(tscene))


@pytest.mark.parametrize("path", SLICE, ids=os.path.basename)
def test_packed_kernel_tables_match_f32(path):
    jscene, tscene = _compile_both(path, jnp.float32, torch.float32)
    np.testing.assert_array_equal(np.asarray(jax_whitted.pack_prims(jscene)),
                                  whitted.pack_prims(tscene).numpy())
    jpat, jdescr = jax_whitted.pack_patterns(jscene)
    tpat, tdescr = whitted.pack_patterns(tscene)
    np.testing.assert_array_equal(np.asarray(jpat), tpat.numpy())
    assert jdescr == tdescr
    np.testing.assert_array_equal(np.asarray(jax_whitted.pack_lights(jscene)),
                                  whitted.pack_lights(tscene).numpy())
    assert jax_whitted.light_meta(jscene) == tuple(
        (light.kind, 0) for light in tscene.lights)


@pytest.mark.parametrize("w,h", [(40, 30), (30, 40)])
def test_camera_rays_match_f64(w, h):
    cam_spec, _, _ = torch_yaml.load_scene_file(SLICE[1])
    jc = jax_camera.Camera(w, h, cam_spec["fov"])
    jc.transform = cam_spec["transform"]
    tc = camera.Camera(w, h, cam_spec["fov"])
    tc.transform = cam_spec["transform"]
    jro, jrd = jax_camera.all_rays_soa(jax_camera.compile_camera(
        jc, jnp.float64))
    tro, trd = camera.all_rays_soa(camera.compile_camera(tc, torch.float64,
                                                        "cpu"))
    for j, t in ((jro, tro), (jrd, trd)):
        for a in "xyz":
            np.testing.assert_allclose(getattr(t, a).numpy(),
                                       np.asarray(getattr(j, a)),
                                       rtol=0, atol=1e-12)


def test_write_png_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.uniform(-0.1, 1.2, size=(12, 17, 3)).astype(np.float32)
    jax_canvas.write_png(str(tmp_path / "a.png"), image)
    canvas.write_png(str(tmp_path / "b.png"), image)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(jax_canvas.to_u8(image), canvas.to_u8(image))
    np.testing.assert_array_equal(jax_canvas.downsample(image[:12, :16], 2),
                                  canvas.downsample(image[:12, :16], 2))


@pytest.mark.parametrize("path", SLICE, ids=os.path.basename)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scene_from_numpy_gives_port_tables(path, dtype):
    """A JAX-compiled scene handed over as numpy equals the port's own
    compile of the same file, tables and structure."""
    jscene, tscene = _compile_both(path, getattr(jnp, dtype),
                                   getattr(torch, dtype))
    carried = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    assert carried.dtype == getattr(torch, dtype)
    _assert_tree_equal(scene_to_numpy(carried), scene_to_numpy(tscene))


def test_port_imports_no_jax():
    code = ("import sys; import rray_tpu_torch, rray_tpu_torch.api, "
            "rray_tpu_torch.cli, rray_tpu_torch.kernels.whitted, "
            "rray_tpu_torch.kernels.triangles, rray_tpu_torch.kernels.bvh, "
            "rray_tpu_torch.kernels.build, rray_tpu_torch.ops.soa, "
            "rray_tpu_torch.render.shade_soa, rray_tpu_torch.io.native, "
            "rray_tpu_torch.kernels.analytic, rray_tpu_torch.ops.prng, "
            "rray_tpu_torch.ops.jitter, rray_tpu_torch.ops.noise, "
            "rray_tpu_torch.ops.quartic, rray_tpu_torch.io.mesh_scenes, "
            "rray_tpu_torch.config, rray_tpu_torch.scene.convert, "
            "rray_tpu_torch.render.camera, rray_tpu_torch.parallel.mesh, "
            "rray_tpu_torch.parallel.train, "
            "rray_tpu_torch.parallel.distributed; "
            "from rray_tpu_torch.render import integrator; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'rray_tpu.')) or m == 'rray_tpu'); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=BASE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=BASE, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_compute_api_runs_on_the_card_by_default(monkeypatch):
    """compile_scene, compile_camera and scene_from_numpy put their
    tensors on the card unless the caller passes device="cpu": without
    CUDA the default raises and returns nothing on the CPU."""
    spec, lights, shapes = torch_yaml.load_scene_file(SLICE[1])
    jscene, _ = _compile_both(SLICE[1], jnp.float32, torch.float32)
    cam = camera.Camera(8, 6, spec["fov"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (lambda **kw: compile_scene(shapes, lights, **kw),
             lambda **kw: camera.compile_camera(cam, torch.float32, **kw),
             lambda **kw: scene_from_numpy(*scene_to_numpy(jscene), **kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
        assert call(device="cpu") is not None
    assert compile_scene(shapes, lights, device="cpu").device == \
        torch.device("cpu")


def test_host_library_builds_from_the_ports_own_source():
    """io/native.py compiles the package's copy of the host runtime,
    which is native/rray_host.cpp byte for byte, into the port's build
    directory."""
    from rray_tpu_torch.io import native

    package = os.path.join(BASE, "rray_tpu_torch")
    src = os.path.abspath(native._SRC)
    assert src.startswith(package + os.sep), src
    with open(src, "rb") as a, open(os.path.join(
            BASE, "native", "rray_host.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(native.library_path()) == os.path.join(
        BASE, "build", "rray_tpu_torch")
