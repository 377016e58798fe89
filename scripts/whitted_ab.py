#!/usr/bin/env python3
"""Time this checkout's whitted kernel against another checkout's, in turns
on one card.

    python3 scripts/whitted_ab.py --other DIR [--scenes a,b,...]
        [--this-rows] [--other-rows]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with `git archive`). Both packages build their
kernels from their own sources; the other one is imported under another
name. For each scene of chip_smoke.py's whitted phases (camera rays at the
scene's size times aa; csg at aa=5 is config 5's full 9600x5400 raster),
the script checks that the two kernels give the same image, then times
each kernel's device time per launch (torch.profiler) in turns other,
this, this, other, and prints one line per scene with the mean of each
side's two turns and their ratio, beside the card's name, clocks and
power limit. Each kernel that takes the raster width gets it, as the
main path passes it (--this-rows, --other-rows: not that one). Needs a CUDA
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (scene file or generated scene, aa, size)
SCENES = {
    "glass": ("examples/glass.yaml", 1, (800, 600)),
    "example1": ("examples/example1.yaml", 1, (800, 600)),
    "mesh4": ("mesh4", 1, (800, 600)),
    "mesh4r": ("mesh4r", 1, (800, 600)),
    "area": ("examples/area_light.yaml", 3, (800, 600)),
    "area4": ("area4", 1, (800, 600)),
    "csg": ("examples/csg_showcase.yaml", 1, (1920, 1080)),
    "csg5r": ("csg5r", 1, (800, 600)),
    "csg_aa5": ("examples/csg_showcase.yaml", 5, (1920, 1080)),
}
WINDOW_MS = 200.0


def load_as(name: str, root: str):
    """Import the rray_tpu_torch package under `root` as `name`."""
    pkg = os.path.join(root, "rray_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_ms(torch, fn):
    """Device time per launch of whitted_kernel over a window of at least
    WINDOW_MS (torch.profiler), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(1, math.ceil(WINDOW_MS / max(start.elapsed_time(stop), 1e-3)))
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in prof.key_averages() if "whitted_kernel" in e.key)
    if total <= 0:
        raise SystemExit("the profiler saw no whitted_kernel time")
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--other-rows", action="store_true",
                    help="give the other kernel no raster width (row order)")
    ap.add_argument("--this-rows", action="store_true",
                    help="give this kernel no raster width (row order)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, ROOT)
    this = importlib.import_module("rray_tpu_torch")
    other = load_as("rray_other", os.path.abspath(args.other))
    from rray_tpu_torch.io import mesh_scenes

    pkgs = {"this": this, "other": other}
    mods = {k: {m: importlib.import_module(f"{p.__name__}.{m}") for m in (
        "kernels.whitted", "kernels.build", "io.yaml_loader",
        "render.camera", "scene.data", "config")} for k, p in pkgs.items()}
    for k, m in mods.items():
        m["kernels.build"].load_library()
        print(f"build {k}: {m['kernels.build'].last_build['seconds']:.1f} s")
    import chip_smoke

    chip_smoke.print_ptxas(mods["this"]["kernels.build"].last_build["log"],
                           chip_smoke.whitted_blocks())
    print("other:")
    chip_smoke.print_ptxas(mods["other"]["kernels.build"].last_build["log"])
    print(card())
    tmp = tempfile.TemporaryDirectory()
    gen = {"mesh4": lambda: mesh_scenes.write_scene(
               tmp.name, "mesh4", lat_lon=(11, 11)),
           "mesh4r": lambda: mesh_scenes.write_scene(
               tmp.name, "mesh4r", lat_lon=(11, 11), reflective=0.3),
           "area4": lambda: mesh_scenes.write_scene(
               tmp.name, "area4", lat_lon=(11, 11), area_level=5),
           "csg5r": lambda: mesh_scenes.write_config5(
               tmp.name, "csg5r", floor_reflective=0.3, area_level=5,
               perturbed_torus=True)}
    for name in args.scenes.split(","):
        src, aa, (w, h) = SCENES[name]
        path = gen[src]() if src in gen else os.path.join(ROOT, src)
        fns, outs = {}, {}
        for k, m in mods.items():
            spec, lights, shapes = m["io.yaml_loader"].load_scene_file(path)
            scene = m["scene.data"].compile_scene(shapes, lights,
                                                  dtype=torch.float32,
                                                  device="cuda")
            cam = m["render.camera"].Camera(w * aa, h * aa, spec["fov"])
            cam.transform = spec["transform"]
            ro, rd = m["render.camera"].all_rays_soa(
                m["render.camera"].compile_camera(cam, torch.float32, "cuda"))
            wh = m["kernels.whitted"]
            inputs = wh.kernel_inputs(scene, m["config"].RenderSettings())
            takes_width = "width" in inspect.signature(
                wh.whitted_compact).parameters
            rows = args.other_rows if k == "other" else args.this_rows
            extra = {"width": w * aa} if takes_width and not rows else {}
            fns[k] = (lambda wh=wh, r=((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z)),
                      i=inputs, e=extra: wh.whitted_compact(*r, **i, **e))
            outs[k] = torch.stack(fns[k]())
        torch.cuda.synchronize()
        diff = float((outs["this"] - outs["other"]).abs().max())
        del outs
        times = {"this": [], "other": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(device_ms(torch, fns[side]))
        t, o = (sum(times[k]) / 2 for k in ("this", "other"))
        last = mods["this"]["kernels.whitted"].last_launch
        print(f"ab {name} {w * aa}x{h * aa}: this {t:.4f} ms, other "
              f"{o:.4f} ms, this/other {t / o:.4f}, max |this - other| "
              f"{diff:.3e}, turns this {times['this']} other "
              f"{times['other']}, launch {last} [{card()}]", flush=True)
        fns.clear()
        torch.cuda.empty_cache()
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
