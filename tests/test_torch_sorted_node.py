"""The sorted torch node (rray_tpu_torch/render/integrator.py) against
rray_tpu's (render/integrator.py, pallas off) in float64 at atol 1e-9:
one node's seven outputs on the hit paths (closest hit, the hybrid CSG
path, the full sorted slots of a mesh inside a CSG), the exhaustive
level scan and the compact wavefront at W = 2, 4 and 2^depth for
depths 1-3, depth 0, and the area-shadow kernel's gate: a scene with a
CSG takes the sample loop over the CSG-filtered any-hit, the same scene
with the CSG split into its operands the kernel (here its plain
version)."""
import jax
import numpy as np
import pytest
import torch
import yaml

import torch_sorted_parity as sp
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_scene
from rray_tpu.io.yaml_loader import load_scene_str as jax_load_str
from rray_tpu.ops.vec import V3 as JV3
from rray_tpu.render import integrator as jint
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.kernels import analytic
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.render import integrator
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

SEED = 3


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("sorted_node")


def _case(tmp, name, n=160, w=12, h=9):
    path, jscene, tscene, jset, tset = sp.scenes(tmp, name)
    (jo, jd), (to, td) = sp.both_rays(*sp.rays(path, n, w, h))
    return jscene, tscene, jset, tset, (jo, jd), (to, td)


def _v3s(out):
    return [(v.x, v.y, v.z) if isinstance(v, (V3, JV3)) else v for v in out]


@pytest.mark.parametrize("name", ["glass", "csgglass", "csgmesh",
                                  "glassmesh"])
def test_node_eval_outputs(tmp, name):
    """surface, over, under, reflect and refract directions, reflect and
    refract weights of one level."""
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, name)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    seeds = jitter.seed_table(SEED, 0, len(tscene.lights))[0].tolist()
    got = integrator._sorted_node_eval(tscene, to, td, tset, seeds)
    want = jint._sorted_node_eval(jscene, jo, jd, jset, key)
    sp.assert_same(_v3s(got), _v3s(want), name)
    assert float(got[0].x.max()) > 0.1


def _wavefront(tmp, name, fn, depth, cap):
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, name)
    jset = JaxSettings(pallas="off", depth=depth, wavefront_capacity=cap,
                       tri_chunk=jset.tri_chunk)
    tset = RenderSettings(depth=depth, wavefront_capacity=cap,
                          tri_chunk=tset.tri_chunk)
    want = getattr(jint, fn)(jscene, jo, jd, depth, jset,
                             jax.random.PRNGKey(SEED))
    got = getattr(integrator, fn)(
        tscene, to, td, depth, tset,
        jitter.seed_table(SEED, depth, len(tscene.lights)))
    sp.assert_same(_v3s([got]), _v3s([want]), f"{fn} depth {depth}")
    return got


@pytest.mark.parametrize("name,depth", [("glass", 1), ("glass", 2),
                                        ("glass", 3), ("glassmesh", 2)])
def test_sorted_scan(tmp, name, depth):
    """The exhaustive scan: W = 2^depth heap-ordered rows."""
    _wavefront(tmp, name, "_color_at_sorted_scan", depth, 4)


@pytest.mark.parametrize("name,depth,cap", [
    ("glass", 1, 2), ("glass", 2, 2), ("glass", 2, 4), ("glass", 3, 4),
    ("glass", 3, 8), ("glassmesh", 3, 4)])
def test_compact_scan(tmp, name, depth, cap):
    """The compact wavefront at W = min(max(cap, 2), 2^depth): 2 and 4
    (the sorted levels), and 2^depth, where it keeps every path."""
    _wavefront(tmp, name, "_color_at_compact_scan", depth, cap)


def test_depth0_evaluates_level0_only(tmp):
    """At depth 0 every wavefront gives level 0's surface (rray_tpu's scan
    fails there when both reflection and refraction spawn), and an
    unknown wavefront name raises."""
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, "glass")
    seeds = jitter.seed_table(SEED, 0, len(tscene.lights))
    want = jint._sorted_node_eval(
        jscene, jo, jd, jset, jax.random.fold_in(jax.random.PRNGKey(SEED),
                                                 0))[0]
    for wavefront in ("compact", "scan", "unrolled"):
        got = integrator.color_at_sorted(
            tscene, to, td, 0, RenderSettings(depth=0, wavefront=wavefront),
            seeds)
        sp.assert_same(_v3s([got]), _v3s([want]), wavefront)
    with pytest.raises(ValueError, match="bogus"):
        integrator.color_at_sorted(tscene, to, td, 1,
                                   RenderSettings(wavefront="bogus"), seeds)


SOLID = {"type": "solid", "color": [0.8, 0.3, 0.2]}
CUBE = {"type": "cube",
        "transforms": [{"type": "translate", "amount": [0, 1.01, 0]}],
        "material": {"pattern": SOLID}}
SPHERE = {"type": "sphere",
          "transforms": [{"type": "scale", "amount": [1.3, 1.3, 1.3]},
                         {"type": "translate", "amount": [0, 1.01, 0]}],
          "material": {"pattern": SOLID, "transparency": 0.5,
                       "refractive_index": 1.5}}


def _gate_scene(split):
    """A floor, a cube minus a transparent sphere (or the two as a
    group) and config 3's area light at level 2, as YAML."""
    obj = ({"type": "group", "children": [CUBE, SPHERE]} if split else
           {"type": "csg", "operation": "difference", "left": CUBE,
            "right": SPHERE})
    return yaml.safe_dump({
        "camera": {"fov": 60, "from": [0, 2.5, -6], "to": [0, 1, 0],
                   "up": [0, 1, 0]},
        "lights": [{"type": "area", "corner": [-5, 5, -5],
                    "uvec": [1.5, 0, 0], "vvec": [0, 1.5, 0], "level": 2,
                    "color": [1, 1, 1]}],
        "scene": [{"type": "plane", "material": {"pattern": SOLID}},
                  obj]}, sort_keys=False)


@pytest.mark.parametrize("split", [False, True])
def test_area_shadow_kernel_gate(split, monkeypatch):
    """With the CSG, the sample loop over the hybrid any-hit; split into
    its operands (a group), the area-shadow kernel's plain version."""
    text = _gate_scene(split)
    _, lights, shapes = jax_load_str(text, ".")
    jscene = compile_scene(shapes, lights, dtype=np.float64)
    tscene = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    assert bool(tscene.csg_ops) != split and tscene.has_transparent
    assert integrator.route(tscene) == ("kernel" if split else "sorted")
    calls = []
    kernel = analytic.area_shadow_fraction
    monkeypatch.setattr(analytic, "area_shadow_fraction",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    rng = np.random.default_rng(5)
    over = rng.uniform([-2.0, 0.01, -2.0], [2.0, 2.5, 2.0], (400, 3)).T
    level, li = 1, 0
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED),
                                                level), 1000 + li)
    want = jint._shadow_fraction_soa(
        jscene, jscene.lights[li], JV3(*over), JaxSettings(pallas="off"),
        key)
    got = integrator._shadow_fraction_soa(
        tscene, tscene.lights[li], V3(*(torch.from_numpy(c) for c in over)),
        RenderSettings(), int(jitter.seed_table(SEED, level, 1)[level, li]))
    sp.assert_same(got, want, "fraction")
    assert len(calls) == (1 if split else 0)
    assert 0.0 < float(got.mean()) < 1.0
