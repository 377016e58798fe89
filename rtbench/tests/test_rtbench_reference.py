"""The plain reference gives the book's values (The Ray Tracer
Challenge, chapter 7's default world) and the port's frames on the CPU."""
import numpy as np
import pytest
import torch

from conftest import ROOT
from rtbench.reference import whitted as rw
from rtbench.reference.rconfig import RenderSettings

DEFAULT_WORLD = """
camera: {fov: 90, from: [0, 0, -5], to: [0, 0, 0], up: [0, 1, 0]}
lights:
  - {type: point, position: %s, color: [1, 1, 1]}
scene:
  - type: sphere
    material:
      pattern: {type: solid, color: [0.8, 1.0, 0.6]}
      diffuse: 0.7
      specular: 0.2
  - type: sphere
    transforms: [{type: scale, amount: [0.5, 0.5, 0.5]}]
    material: {pattern: {type: solid, color: [1, 1, 1]}}
"""


def colour(light, origin, direction):
    _, scene = rw.load(DEFAULT_WORLD % light, ".", torch.float64)
    ro = torch.tensor([origin], dtype=torch.float64)
    rd = torch.tensor([direction], dtype=torch.float64)
    return rw.trace(scene, ro, rd, RenderSettings(depth=0))[0].numpy()


def test_the_books_values():
    # Shading an intersection; shading it from the inside.
    assert np.allclose(colour("[-10, 10, -10]", [0, 0, -5], [0, 0, 1]),
                       [0.38066, 0.47583, 0.2855], atol=1e-5)
    assert np.allclose(colour("[0, 0.25, 0]", [0, 0, 0], [0, 0, 1]),
                       [0.90498, 0.90498, 0.90498], atol=1e-5)
    # A ray that misses is black.
    assert np.allclose(colour("[-10, 10, -10]", [0, 0, -5], [0, 1, 0]), 0)


def test_the_reference_agrees_with_the_port_on_the_cpu():
    from rray_tpu_torch import api

    for name, w, h, aa in (("glass", 32, 24, 1), ("csg_showcase", 24, 14, 2)):
        path = f"{ROOT}/examples/{name}.yaml"
        img = api.render_scene_from_file(path, w, h, None, aa=aa,
                                         device="cpu")
        spec, scene = rw.load(open(path).read(), f"{ROOT}/examples")
        cam = rw.camera(spec, w * aa, h * aa)
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        ref = rw.pixels(scene, cam, xs.reshape(-1), ys.reshape(-1), aa,
                        RenderSettings()).reshape(h, w, 3).numpy()
        # Two float32 formulations of one scene: within 1e-3 (the harness's
        # pix_share tolerance) on every pixel of these frames.
        assert np.abs(ref - img).max() < 1e-3, name


def small_frame(registry, cell):
    """(scene YAML text, its base folder, width, height, aa, settings) of
    a cell's configuration at the cell's small size."""
    import os

    import yaml

    from conftest import SMALL

    cfg = {**registry.config(registry.cell(cell)["config"]),
           **SMALL[cell]["config"]}
    mix = {**registry.mix(registry.cell(cell)["traffic"]),
           **SMALL[cell]["mix"]}
    settings = RenderSettings(depth=cfg["depth"],
                              wavefront_capacity=cfg["wavefront_capacity"])
    return (yaml.safe_dump(cfg["scene"]),
            os.path.join(registry.bench_dir, "configs", "assets"),
            cfg["width"], cfg["height"], mix["aa"], settings)


@pytest.mark.parametrize("cell", ["glass.turntable",
                                  "csg_showcase.turntable_aa5"])
def test_point_lights_render_the_same_bits_as_before_the_seam(cell,
                                                              registry):
    """whitted_before.npz: the pixels and first five raster rows of each
    frame at its small size, as whitted.py rendered them before its
    shadow fraction was chosen by the light's kind."""
    import os

    text, base, w, h, aa, settings = small_frame(registry, cell)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    spec, scene = rw.load(text, base)
    cam = rw.camera(spec, w * aa, h * aa)
    now = {"pixels": rw.pixels(scene, cam, xs.reshape(-1), ys.reshape(-1),
                               aa, settings),
           "frame_rows": rw.frame_rows(scene, cam, 0, 5, settings)}
    before = np.load(os.path.join(os.path.dirname(__file__),
                                  "whitted_before.npz"))
    for key, got in now.items():
        assert np.array_equal(got.numpy(), before[f"{cell}.{key}"]), key


def test_a_light_kind_no_module_gives_is_refused():
    import dataclasses

    spec, scene = rw.load(open(f"{ROOT}/examples/area_light.yaml").read(),
                          f"{ROOT}/examples")
    scene = dataclasses.replace(scene, lights=(
        dataclasses.replace(scene.lights[0], kind="spot"),))
    cam = rw.camera(spec, 8, 6)
    with pytest.raises(NotImplementedError, match="spot"):
        rw.pixels(scene, cam, torch.tensor([3]), torch.tensor([2]), 1,
                  RenderSettings())


def test_a_kind_of_light_takes_its_shadow_from_its_own_module(monkeypatch):
    """A light whose kind names a module of reference/ gets that module's
    shadow fraction, with its index and every level of the tree; what it
    returns is the blocked fraction (all blocked: ambient alone)."""
    import dataclasses
    import sys
    import types

    _, scene = rw.load(DEFAULT_WORLD % "[-10, 10, -10]", ".", torch.float64)
    scene = dataclasses.replace(scene, lights=(
        dataclasses.replace(scene.lights[0], kind="probe"),))
    seen = set()

    def shadow(scene, li, light, over, settings, level):
        seen.add((li, level))
        return torch.ones_like(over[:, 0])

    monkeypatch.setitem(sys.modules, "rtbench.reference.probe",
                        types.SimpleNamespace(shadow=shadow))
    ro = torch.tensor([[0.0, 0.0, -5.0]], dtype=torch.float64)
    rd = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    got = rw.trace(scene, ro, rd, RenderSettings(depth=0))
    assert seen == {(0, 0)}
    # The book's sphere: colour 0.8, 1.0, 0.6 at ambient 0.1.
    assert np.allclose(got[0].numpy(), [0.08, 0.1, 0.06], atol=1e-12)
