"""High-level rendering API (scene_builder_yaml.rs:387-436 equivalents).

`render_scene_from_file/str(path, width, height, png_file, aa)` reproduces
the reference pipeline: build the scene from YAML, size the camera at
width*aa x height*aa (scene_builder_yaml.rs:392), render, box-downsample
by aa on the raster's device (kernels/downsample.py, so only the image
is copied to the host), and write the PNG: from the card, an image there
has its deflate matches searched there too (io/deflate.py), with
compress2's bytes. The device is explicit:
"cuda" runs the CUDA kernels and is an error where CUDA is missing; "cpu"
runs their plain PyTorch versions. `render_scene_progressive` renders
band by band with a checkpoint (the CLI's --checkpoint) and downsamples
its host canvas, and `render_resilient` restarts that CLI in child
processes until the frame is done.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .config import RenderSettings, checked_device, default_dtype
from .io import deflate
from .io.yaml_loader import load_scene_file, load_scene_str
from .kernels import downsample
from .render import canvas
from .render.camera import Camera, compile_camera
from .render.integrator import render
from .scene.data import compile_scene
from .utils import profiling

log = logging.getLogger("rray_tpu_torch")


def _build(camera_spec, lights, shapes, width, height, aa, dtype, dev):
    scene = compile_scene(shapes, lights, dtype=dtype, device=dev)
    cam = Camera(width * aa, height * aa, camera_spec["fov"])
    cam.transform = camera_spec["transform"]
    return scene, compile_camera(cam, dtype, dev)


def _render_image(camera_spec, lights, shapes, width, height, aa, settings,
                  seed, dtype, device):
    """render_scene up to the copy: the downsampled image, left on the
    raster's device, and a function that copies it to the host."""
    dev = checked_device(device)
    settings = settings or RenderSettings()
    scene, cam = _build(camera_spec, lights, shapes, width, height, aa,
                        dtype or default_dtype(), dev)
    t0 = time.perf_counter()
    image = render(scene, cam, settings, seed)
    if aa > 1:
        # On the raster's device, before the copy: only the image crosses.
        with profiling.span("downsample"):
            image = downsample.downsample(image, aa)

    def to_host() -> np.ndarray:
        with profiling.span("copy"):
            host = image.cpu().numpy()
        log.info("rendered %dx%d (aa=%d, %d raster rays) on %s: render and "
                 "copy to the host %.3fs", width, height, aa,
                 cam.hsize * cam.vsize, dev, time.perf_counter() - t0)
        return host

    return image, to_host


def render_scene(camera_spec, lights, shapes, width: int, height: int,
                 aa: int = 1, settings: RenderSettings = None, seed: int = 0,
                 dtype=None, device="cuda") -> np.ndarray:
    """Render a loaded scene -> linear float image [height, width, 3]
    (already AA-downsampled). `seed` keys the area lights' jitter draws,
    as rray_tpu's `seed` does (the same seed gives the same image);
    point lights draw no random numbers. dtype None: default_dtype()."""
    return _render_image(camera_spec, lights, shapes, width, height, aa,
                         settings, seed, dtype, device)[1]()


def _render_frame(loaded, width, height, png_file, aa, settings, seed, dtype,
                  device) -> np.ndarray:
    """A loaded scene's frame: the image copied to the host, and the PNG
    written from where the image lies. An image on the card has its
    deflate matches searched there (io/deflate.py); a host image goes
    through canvas.write_png. Both write the same bytes."""
    camera_spec, lights, shapes = loaded
    image, to_host = _render_image(camera_spec, lights, shapes, width,
                                   height, aa, settings, seed, dtype, device)
    host = to_host()
    if png_file:
        if image.device.type == "cuda":
            deflate.write_png(png_file, image)
        else:
            canvas.write_png(png_file, host)
    return host


def render_scene_from_str(contents: str, width: int, height: int,
                          png_file: str, aa: int = 1, base_dir: str = ".",
                          settings: RenderSettings = None, seed: int = 0,
                          dtype=None, device="cuda") -> np.ndarray:
    with profiling.span("frame"):
        return _render_frame(load_scene_str(contents, base_dir), width,
                             height, png_file, aa, settings, seed, dtype,
                             device)


def render_scene_from_file(path: str, width: int, height: int,
                           png_file: str, aa: int = 1,
                           settings: RenderSettings = None, seed: int = 0,
                           dtype=None, device="cuda") -> np.ndarray:
    with profiling.span("frame"):
        return _render_frame(load_scene_file(path), width, height, png_file,
                             aa, settings, seed, dtype, device)


def render_scene_progressive(path: str, width: int, height: int,
                             png_file: str, aa: int = 1, seed: int = 0,
                             band_rows: int = 64,
                             checkpoint_path: str = None,
                             settings: RenderSettings = None, dtype=None,
                             device="cuda") -> np.ndarray:
    """Band-by-band render with checkpoint/resume (CLI --checkpoint).

    A checkpoint that exists (same scene and camera) is resumed: only
    unfinished bands render. One that cannot be read is logged and the
    frame starts fresh, as in rray_tpu. The PNG is written once the
    frame completes."""
    from .render.progressive import ProgressiveRender

    dev = checked_device(device)
    settings = settings or RenderSettings()
    with profiling.span("frame"):
        camera_spec, lights, shapes = load_scene_file(path)
        scene, cam = _build(camera_spec, lights, shapes, width, height, aa,
                            dtype or default_dtype(), dev)
        prog = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                prog = ProgressiveRender.resume(checkpoint_path, scene, cam,
                                                settings, seed, band_rows)
            except Exception as e:  # truncated/corrupt checkpoint: restart
                log.warning("checkpoint %s unreadable (%s); starting fresh",
                            checkpoint_path, e)
        if prog is None:
            prog = ProgressiveRender(scene, cam, settings, seed, band_rows,
                                     checkpoint_path)
        image = canvas.downsample(prog.run(), aa)
        if png_file:
            canvas.write_png(png_file, image)
    return image


def render_resilient(path: str, width: int, height: int, png_file: str,
                     aa: int = 1, seed: int = 0, band_rows: int = 64,
                     checkpoint_path: str = None, attempts: int = 4,
                     wait_s: float = 0.0, device: str = "cuda") -> int:
    """Full-frame render that survives crashed workers: the
    checkpointing CLI (python -m rray_tpu_torch.cli --checkpoint) runs
    in a child process on `device`, and a child that fails is restarted;
    each restart resumes from the band checkpoint, so finished bands are
    never rendered again. A failed CUDA context cannot be recovered in
    its process, so the unit of restart is a process. Gives up after
    two attempts in a row without progress, as rray_tpu does. Returns
    the last child's return code (0: frame complete, PNG written)."""
    import subprocess
    import sys
    import tempfile

    if checkpoint_path is None:
        checkpoint_path = os.path.join(
            tempfile.mkdtemp(prefix="rray_ckpt_"), "frame.npz")
    cmd = [sys.executable, "-m", "rray_tpu_torch.cli", "-s", path,
           "-W", str(width), "-H", str(height), "-o", png_file,
           "-a", str(aa), "--seed", str(seed), "--device", str(device),
           "--checkpoint", checkpoint_path, "--band-rows", str(band_rows)]
    # The children import this checkout's package, wherever they start.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    last_done = -1
    rc = 1
    for attempt in range(attempts):
        rc = subprocess.call(cmd, env=env)
        if rc == 0:
            return 0
        done = -1
        if os.path.exists(checkpoint_path):
            try:
                with np.load(checkpoint_path) as state:
                    done = int(state["done"].sum())
            except Exception:  # corrupt checkpoint: the child restarts
                done = -1
        log.warning("render attempt %d failed (rc=%d, %d bands done)",
                    attempt + 1, rc, max(done, 0))
        if done <= last_done and attempt:
            # No forward progress two attempts running: give up.
            return rc
        last_done = done
        if wait_s:
            time.sleep(wait_s)
    return rc
