"""Area lights through the port's main path on the CPU: the torch fast
node's area branch against rray_tpu's `_color_at_soa_xla` (pallas off) in
float64 at atol 1e-9 with the same seed (21 analytic prims: the
area-shadow kernel's plain version; a nine-group mesh: the sample loop
over the triangle any-hit), and `render_scene_from_file`'s seed: it
reaches the draws (rray_tpu's image for the same seed, another image for
another seed)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.api as jax_api
import torch_mesh_parity as mp
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu.ops.vec import V3 as JV3
from rray_tpu.render import integrator as jax_integrator
from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import analytic
from rray_tpu_torch.ops import jitter, soa
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.render import canvas, integrator
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AREA = os.path.join(BASE, "examples", "area_light.yaml")
# Fast-node area scenes: 20 small spheres over a reflective checker floor
# (21 analytic prims, more than the whitted kernel takes), and nine mesh
# groups (more than 8) over a reflective floor.
FAST = {"area21": (dict(lat_lon=None, spheres=20, reflective=0.3,
                        area_level=5), 5, 11),
        "area_nine": (dict(lat_lon=(3, 4), grid=True, reflective=0.3,
                           area_level=3), 2, 12)}


@pytest.mark.parametrize("name", list(FAST))
def test_fast_node_area_matches_xla_f64(name, tmp_path, monkeypatch):
    kw, depth, seed = FAST[name]
    path, jscene, tscene = mp.scenes(tmp_path, name, "float64", **kw)
    assert integrator.route(tscene) == "fast"
    o, d = mp.camera_rays(path, 32, 24, "float64")
    ref = jax_integrator._color_at_soa_xla(
        jscene, JV3(*(jnp.asarray(c) for c in o)),
        JV3(*(jnp.asarray(c) for c in d)), depth,
        JaxSettings(pallas="off", depth=depth), jax.random.PRNGKey(seed))
    calls = []
    plain = analytic.area_shadow_fraction

    def spy(*args, **kwargs):
        calls.append(args[-1])
        return plain(*args, **kwargs)

    monkeypatch.setattr(analytic, "area_shadow_fraction", spy)
    out = integrator.color_at_fast(
        tscene, V3(*(torch.from_numpy(c) for c in o)),
        V3(*(torch.from_numpy(c) for c in d)), depth,
        RenderSettings(depth=depth),
        jitter.seed_table(seed, depth, len(tscene.lights)))
    for a, b in zip((out.x, out.y, out.z), (ref.x, ref.y, ref.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    assert float(out.x.abs().max()) > 0.1
    # B5 takes the analytic scene's shadows, one call per live level; the
    # mesh scene's go through the sample loop.
    assert (calls and set(calls) == {5}) if name == "area21" else not calls


def test_any_number_of_analytic_prims_reaches_the_area_kernel(
        tmp_path, monkeypatch):
    """801 analytic prims, past the 327 prims whose rows area.cu stages
    in shared memory (it reads more from global memory): the fast node
    hands a mesh-free analytic area scene to B5 whatever its prim count,
    as rray_tpu does, and never to the plain sample loop."""
    _, lights, shapes = load_scene_file(ms.write_scene(
        str(tmp_path), "many", lat_lon=None, spheres=800, area_level=2))
    scene = compile_scene(shapes, lights, device="cpu")
    calls = []
    monkeypatch.setattr(analytic, "area_shadow_fraction",
                        lambda *a, **k: calls.append(a) or torch.zeros(4))
    monkeypatch.setattr(soa, "any_hit_soa",
                        lambda *a: pytest.fail("the plain sample loop ran"))
    over = V3(*(torch.zeros(4) for _ in range(3)))
    integrator._shadow_fraction_soa(scene, scene.lights[0], over,
                                    RenderSettings(), 0)
    assert len(calls) == 1 and len(calls[0][4]) == 801


@pytest.mark.parametrize("seed", [0, 21])
def test_render_scene_from_file_seed_matches_rray_tpu_f64(seed, tmp_path):
    want = np.asarray(jax_api.render_scene_from_file(
        AREA, 24, 18, str(tmp_path / "a.png"), aa=2, seed=seed,
        dtype=jnp.float64))
    got = api.render_scene_from_file(AREA, 24, 18, str(tmp_path / "b.png"),
                                     aa=2, seed=seed, dtype=torch.float64,
                                     device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(canvas.to_u8(got), canvas.to_u8(want))


def test_seed_reaches_the_draws():
    """The same seed gives the same image; another seed moves the soft
    shadows' pixels and nothing else."""
    render = lambda s: api.render_scene_from_file(AREA, 32, 24, "", seed=s,
                                                  device="cpu")
    a, b, c = render(1), render(1), render(2)
    np.testing.assert_array_equal(a, b)
    moved = np.abs(a - c).max(axis=-1) > 0
    assert 0.0 < moved.mean() < 0.5


def test_area_scene_on_cuda_without_cuda_is_an_error(monkeypatch):
    """device="cuda" never falls back to the CPU's plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        api.render_scene_from_file(AREA, 8, 6, "", device="cuda")
