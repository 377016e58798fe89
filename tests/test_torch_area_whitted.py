"""Stage c of the whitted kernel (area lights), plain version: against
rray_tpu's kernel-free XLA node (`_xla_reference_node`, pallas off) in
float64 at atol 1e-9, with the same seed, on examples/area_light.yaml
(BASELINE config 3) at depth 0, the same scene over a reflective floor
at depth 5 (one seed per level), and a 60-triangle mesh under the area
light (stages c + d); and in float32 against rray_tpu's Pallas kernel
(interpret mode) fed the same seed table, at level 3."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.io.yaml_loader as jax_yaml
import torch_mesh_parity as mp
import torch_parity as tp
from rray_tpu import compile_scene
from rray_tpu.kernels import whitted as jax_whitted
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render import integrator
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

AREA = os.path.join(tp.BASE, "examples", "area_light.yaml")


def _area_scenes(dtype, floor_reflective=0.0, level=None):
    """(rray_tpu scene, port scene) of area_light.yaml, optionally with a
    reflective floor or another light level."""
    _, lights, shapes = jax_yaml.load_scene_file(AREA)
    shapes[0].material.reflective = floor_reflective
    if level is not None:
        lights[0].level = level
    jscene = compile_scene(shapes, lights, dtype=getattr(jnp, dtype))
    return jscene, scene_from_numpy(*scene_to_numpy(jscene), device="cpu")


def _port(tscene, o, d, seed, depth=5):
    inputs = whitted.kernel_inputs(tscene, RenderSettings(depth=depth), seed)
    out = whitted.whitted_compact(*(tuple(torch.from_numpy(c) for c in x)
                                    for x in (o, d)), **inputs)
    return np.stack([c.numpy() for c in out]), inputs


def _xla(jscene, o, d, seed, depth=5):
    from rray_tpu import RenderSettings as JaxSettings
    from rray_tpu.ops.vec import V3
    from rray_tpu.render import integrator as jax_integrator

    out = jax_integrator._xla_reference_node(
        jscene, V3(*(jnp.asarray(c) for c in o)),
        V3(*(jnp.asarray(c) for c in d)), depth,
        JaxSettings(pallas="off", depth=depth), jax.random.PRNGKey(seed))
    return np.stack([np.asarray(c) for c in (out.x, out.y, out.z)])


@pytest.mark.parametrize("floor_reflective,seed,want_depth",
                         [(0.0, 0, 0), (0.0, 3, 0), (0.3, 5, 5)])
def test_area_light_matches_xla_f64(floor_reflective, seed, want_depth):
    jscene, tscene = _area_scenes("float64", floor_reflective)
    assert integrator.route(tscene) == "kernel"
    o, d = mp.camera_rays(AREA, 32, 24, "float64")
    port, inputs = _port(tscene, o, d, seed)
    assert inputs["depth"] == want_depth and inputs["light_levels"] == (5,)
    np.testing.assert_allclose(port, _xla(jscene, o, d, seed), rtol=0,
                               atol=1e-9)
    # Soft shadows: the floor holds fractional shadow values.
    assert len(np.unique(np.round(port[2], 6))) > 20


def test_area_mesh_matches_xla_f64(tmp_path):
    """A 60-triangle mesh under config 3's light: stage c with the mesh
    any-hit per sample (stage d)."""
    path, jscene, tscene = mp.scenes(tmp_path, "area60", "float64",
                                     lat_lon=(6, 6), area_level=5)
    assert tscene.counts[6] == 60 and integrator.route(tscene) == "kernel"
    o, d = mp.camera_rays(path, 32, 24, "float64")
    port, _ = _port(tscene, o, d, 9)
    np.testing.assert_allclose(port, _xla(jscene, o, d, 9), rtol=0,
                               atol=1e-9)
    assert port.max() > 0.1


# f32 budget against rray_tpu's interpret-mode kernel with area lights.
# Both hash the float32 bits of the over point, and XLA:CPU's compiled
# rounding of the over point (FMA contraction) differs from eager
# PyTorch's by an ulp on some rays: such a ray draws a different set of
# jitter samples and its shadow fraction moves by whole 1/n steps.
# Measured on these 4096 rays at level 3: 98.3% within 2e-6, 98.8%
# within 1e-4, max 0.099, mean |diff| 5.2e-4, image means within 3e-4
# relative. The budget: tests/torch_parity.py's 98% within 2e-6, 98.5%
# within 1e-4, mean |diff| <= 2e-3 and image means within 1e-3.
AREA_LOOSE_SHARE, AREA_MEAN_DIFF, AREA_MEAN_REL = 0.985, 2e-3, 1e-3


def test_area_light_matches_pallas_kernel_f32():
    """Level 3 at depth 0 on 4096 seeded rays, the same seed table fed to
    both, under the budget above."""
    jscene, tscene = _area_scenes("float32", level=3)
    o, d = tp.seeded_rays()
    port, inputs = _port(tscene, o, d, 4)
    assert (inputs["depth"], inputs["W"]) == (0, 1)
    pat, descrs = jax_whitted.pack_patterns(jscene)
    ref = jax_whitted.whitted_compact(
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jax_whitted.pack_prims(jscene), pat, jax_whitted.pack_lights(jscene),
        jnp.asarray(inputs["seeds"].numpy()), kinds=tuple(jscene.prim_kinds),
        pat_descrs=descrs, prim_pat=tuple(jscene.prim_pattern_static),
        lmeta=jax_whitted.light_meta(jscene), depth=0, W=1, has_refl=False,
        has_refr=False, interpret=True)
    ref = np.stack([np.asarray(c) for c in ref])
    diff = tp.ray_diff(port, ref)
    assert np.isfinite(port).all()
    assert float((diff <= tp.F32_TIGHT).mean()) >= tp.F32_TIGHT_SHARE
    assert float((diff <= tp.F32_LOOSE).mean()) >= AREA_LOOSE_SHARE
    assert float(diff.mean()) <= AREA_MEAN_DIFF
    assert abs(port.mean() - ref.mean()) <= AREA_MEAN_REL * ref.mean()


def test_missing_seed_table_is_refused():
    _, tscene = _area_scenes("float32")
    inputs = whitted.kernel_inputs(tscene, RenderSettings())
    seeds = inputs.pop("seeds")
    rays = tuple(torch.zeros(4) for _ in range(3))
    with pytest.raises(TypeError, match="seeds"):
        whitted.whitted_compact(rays, rays, **inputs)
    with pytest.raises(ValueError, match="seeds"):
        whitted.whitted_compact(rays, rays, **inputs, seeds=seeds[:-1])
