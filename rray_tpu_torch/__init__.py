"""rray_tpu_torch: the rray_tpu raytracer on PyTorch and CUDA.

The port of rray_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100. Plain
tensor code is PyTorch; each Pallas TPU kernel on the ported path is a
CUDA kernel written by hand for Hopper, with a plain PyTorch version
beside it that CPU tensors run. Renders are differentiable: autograd
reaches every float leaf of a scene through `render`, and
`rray_tpu_torch.parallel.train` trains scene parameters against a target
image with torch.optim. rray_tpu stays the reference the port is tested
against; this package never imports JAX.
"""
from .config import EPSILON, RenderSettings, default_dtype
from .scene.data import (AreaLight, Material, Pattern, PointLight, Shape,
                         compile_scene, glass_material)
from .render.camera import Camera, compile_camera
from .render.integrator import color_at, render

__all__ = [
    "EPSILON", "RenderSettings", "default_dtype",
    "AreaLight", "Material", "Pattern", "PointLight", "Shape",
    "compile_scene", "glass_material",
    "Camera", "compile_camera", "color_at", "render",
    "render_scene_from_file", "render_scene_from_str",
]


def __getattr__(name):
    # Lazy: the api module pulls in IO dependencies (PIL, yaml) that
    # compute-only use does not need.
    if name in ("render_scene_from_file", "render_scene_from_str"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
