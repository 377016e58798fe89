#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rray_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives
the main path (rray_tpu_torch.api.render_scene_from_file, what the CLI
calls) at 800x600, and times kernel and plain version with CUDA events.
It prints the card, one line per phase, a JSON line describing the
kernels, and last a JSON line naming the device. Any failure exits
non-zero before the last line; without CUDA it exits 1 at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 800, 600
SCENES = (("glass", "examples/glass.yaml"),
          ("example1", "examples/example1.yaml"))
# Kernel vs plain version, float32 on the card: at most this fraction of
# pixels may differ by more than PIX_TOL in some channel (rsqrtf/powf
# ulps can flip a shadow or n1/n2 boundary decision), and no pixel by
# more than MAX_TOL (one u8 step).
PIX_TOL = 1e-4
FRAC_TOL = 1e-3
MAX_TOL = 1.0 / 255.0
KERNEL_REPS, PLAIN_REPS = 20, 3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def camera_rays(path, torch):
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.render.camera import (Camera, all_rays_soa,
                                              compile_camera)
    from rray_tpu_torch.scene.data import compile_scene

    cam_spec, lights, shapes = load_scene_file(os.path.join(ROOT, path))
    scene = compile_scene(shapes, lights, dtype=torch.float32, device="cuda")
    cam = Camera(WIDTH, HEIGHT, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    return scene, all_rays_soa(compile_camera(cam, torch.float32, "cuda"))


def kernel_args(scene):
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import whitted

    pat_tbl, descrs = whitted.pack_patterns(scene)
    depth, W = whitted.wavefront_shape(scene, RenderSettings())
    return (whitted.pack_prims(scene), pat_tbl, whitted.pack_lights(scene),
            scene.prim_kinds, descrs, scene.prim_pattern_static, depth, W,
            scene.has_reflective, scene.has_transparent)


def frame_ms(torch, fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(torch, kernel_rgb, plain_rgb, what):
    """(max abs difference, fraction of pixels over PIX_TOL)."""
    k = torch.stack(kernel_rgb, -1)
    p = torch.stack(plain_rgb, -1)
    if not bool(torch.isfinite(k).all()):
        fail(f"{what}: the kernel produced non-finite values")
    diff = (k - p).abs().amax(dim=-1)
    max_abs = float(diff.max())
    frac = float((diff > PIX_TOL).double().mean())
    if frac > FRAC_TOL or max_abs > MAX_TOL:
        fail(f"{what}: kernel vs plain max |diff| {max_abs:.3e}, "
             f"{frac:.3e} of pixels over {PIX_TOL} (limits {MAX_TOL:.3e}, "
             f"{FRAC_TOL})")
    return max_abs, frac


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import numpy as np
    from PIL import Image

    from rray_tpu_torch import api
    from rray_tpu_torch.kernels import build, whitted

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    build.load_library()
    info = build.last_build
    print(f"build: {info['seconds']:.3f} s, cache hit: {info['cache_hit']}, "
          f"{os.path.relpath(info['path'], ROOT)}")
    for line in info["log"].splitlines():
        if "registers" in line:  # one line per W instantiation
            print(f"  {line.strip()}")

    # Kernel against its plain version on the main path's camera rays.
    results = {}
    for name, path in SCENES:
        scene, (ro, rd) = camera_rays(path, torch)
        rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
        args = kernel_args(scene)
        kern = whitted.whitted_compact(*rays, *args)
        plain = whitted.whitted_compact_reference(*rays, *args)
        torch.cuda.synchronize()
        max_abs, frac = compare(torch, kern, plain, name)
        print(f"parity {name} {WIDTH}x{HEIGHT} (depth {args[-4]}, "
              f"W {args[-3]}): max |kernel - plain| {max_abs:.3e}, "
              f"pixels over {PIX_TOL}: {frac:.3e}")
        results[name] = dict(rays=rays, args=args, max_abs=max_abs,
                             plain=plain)

    # The main path, as the CLI drives it: counts from zero.
    whitted.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        images = {}
        for name, path, aa in (("glass", SCENES[0][1], 1),
                               ("example1", SCENES[1][1], 1),
                               ("example1", SCENES[1][1], 2)):
            png = os.path.join(tmp, f"{name}_aa{aa}.png")
            t0 = time.perf_counter()
            image = api.render_scene_from_file(
                os.path.join(ROOT, path), WIDTH, HEIGHT, png, aa=aa,
                device="cuda")
            wall = time.perf_counter() - t0
            shape = np.asarray(Image.open(png)).shape
            if shape != (HEIGHT, WIDTH, 4):
                fail(f"{png}: PNG shape {shape}")
            if not np.isfinite(image).all():
                fail(f"{name} aa={aa}: non-finite image")
            images[(name, aa)] = image
            print(f"main path {name} {WIDTH}x{HEIGHT} aa={aa}: PNG {shape}, "
                  f"{wall * 1e3:.1f} ms wall, PNG write included [{card}]")
    launches = whitted.launches
    print(f"main path kernel launches: {launches}")
    if launches < 3:
        fail(f"the main path launched the whitted kernel {launches} times")
    # The main path's aa=1 frames against the plain version's.
    for name, _ in SCENES:
        img = torch.from_numpy(images[(name, 1)]).cuda().reshape(-1, 3)
        compare(torch, img.unbind(-1), results[name]["plain"],
                f"main path {name}")

    # Times on the card, after one warm-up run each.
    for name, _ in SCENES:
        rays, args = results[name]["rays"], results[name]["args"]
        ms = frame_ms(torch, lambda: whitted.whitted_compact(*rays, *args),
                      KERNEL_REPS)
        plain_ms = frame_ms(
            torch, lambda: whitted.whitted_compact_reference(*rays, *args),
            PLAIN_REPS)
        n = WIDTH * HEIGHT
        results[name].update(ms=ms, plain_ms=plain_ms)
        print(f"time {name} {WIDTH}x{HEIGHT}: kernel {ms:.4f} ms/frame "
              f"({n / ms * 1e3:.4g} primary rays/s), plain {plain_ms:.4f} "
              f"ms/frame ({n / plain_ms * 1e3:.4g} primary rays/s) [{card}]")

    glass = results["glass"]
    print(json.dumps({"kernels": [{
        "name": "whitted_compact", "route": "cuda",
        "source": "rray_tpu_torch/kernels/csrc/whitted.cu",
        "replaces": "rray_tpu/kernels/whitted.py:1464",
        "launches": launches,
        "max_abs_err": max(r["max_abs"] for r in results.values()),
        "ms": glass["ms"], "plain_ms": glass["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
