"""The plain reference gives the book's values (The Ray Tracer
Challenge, chapter 7's default world) and the port's frames on the CPU."""
import numpy as np
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
