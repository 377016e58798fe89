"""High-level rendering API (scene_builder_yaml.rs:387-436 equivalents).

`render_scene_from_file/str(path, width, height, png_file, aa)` reproduces
the reference pipeline: build the scene from YAML, size the camera at
width*aa x height*aa (scene_builder_yaml.rs:392), render, box-downsample
by aa, and write the PNG. The device is explicit: "cuda" runs the CUDA
kernels and is an error where CUDA is missing; "cpu" runs their plain
PyTorch versions.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .config import RenderSettings
from .io.yaml_loader import load_scene_file, load_scene_str
from .render import canvas
from .render.camera import Camera, compile_camera
from .render.integrator import render
from .scene.data import compile_scene

log = logging.getLogger("rray_tpu_torch")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested, but "
                           "torch.cuda.is_available() is False")
    return dev


def render_scene(camera_spec, lights, shapes, width: int, height: int,
                 aa: int = 1, settings: RenderSettings = None, seed: int = 0,
                 dtype=torch.float32, device="cuda") -> np.ndarray:
    """Render a loaded scene -> linear float image [height, width, 3]
    (already AA-downsampled). `seed` keys the area lights' jitter draws,
    as rray_tpu's `seed` does (the same seed gives the same image);
    point lights draw no random numbers."""
    dev = _device(device)
    settings = settings or RenderSettings()
    scene = compile_scene(shapes, lights, dtype=dtype, device=dev)
    cam = Camera(width * aa, height * aa, camera_spec["fov"])
    cam.transform = camera_spec["transform"]
    t0 = time.perf_counter()
    image = render(scene, compile_camera(cam, dtype, dev), settings, seed)
    image = image.cpu().numpy()
    dt = time.perf_counter() - t0
    log.info("rendered %dx%d (aa=%d) on %s: %.3fs, %.3g primary rays/s",
             width, height, aa, dev, dt, cam.hsize * cam.vsize / max(dt, 1e-9))
    return canvas.downsample(image, aa)


def render_scene_from_str(contents: str, width: int, height: int,
                          png_file: str, aa: int = 1, base_dir: str = ".",
                          settings: RenderSettings = None, seed: int = 0,
                          dtype=torch.float32, device="cuda") -> np.ndarray:
    camera_spec, lights, shapes = load_scene_str(contents, base_dir)
    image = render_scene(camera_spec, lights, shapes, width, height, aa,
                         settings, seed, dtype, device)
    if png_file:
        canvas.write_png(png_file, image)
    return image


def render_scene_from_file(path: str, width: int, height: int,
                           png_file: str, aa: int = 1,
                           settings: RenderSettings = None, seed: int = 0,
                           dtype=torch.float32, device="cuda") -> np.ndarray:
    camera_spec, lights, shapes = load_scene_file(path)
    image = render_scene(camera_spec, lights, shapes, width, height, aa,
                         settings, seed, dtype, device)
    if png_file:
        canvas.write_png(png_file, image)
    return image
