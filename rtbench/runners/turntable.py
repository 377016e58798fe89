"""A camera move rendered through the CLI's entry, frame after frame.

Frame i is one rray_tpu_torch.api.render_scene_from_file call on a YAML
file of its own: the configuration's scene with the camera turned about
the vertical axis through its authored `to`, at the authored radius and
height. The start angle is drawn from the seed within the mix's range
about the authored view; the camera steps `step_deg` a frame and turns
back at the ends of the range. Every YAML of the cycle is written in
set-up (beside the configuration's assets, under $TMPDIR); one PNG path
is overwritten each frame.

The check, after the window: `check_frames` frames drawn from the seed
out of the window's (reservoir sampling), and the last frame, whose PNG
is the one on disk. At `check_pixels` output pixels of each, drawn from
the seed, the frozen reference (reference/whitted.py) renders the same
YAML again in float32, from the text, with the aa x aa raster rays each
pixel averages. Numbers: `pix_share`, the share of those pixels whose
largest channel differs from the frame the call returned by more than
1e-3 (the budget of the port's per-ray oracle for two float32
formulations of one scene); `png_share`, the share of the last frame's
pixels whose PNG channels, decoded, differ from the reference's
truncated 8-bit value by more than one level (a value on a level's edge
may round either way).
"""
from __future__ import annotations

import math
import os
import random
import shutil
import tempfile
import types

import numpy as np

UNIT = "frame"
SPANS = (("rray_tpu_torch.api:load_scene_file", "load_scene_file"),
         ("rray_tpu_torch.api:compile_scene", "compile_scene"),
         ("rray_tpu_torch.api:render", "render"))

PIX_TOL = 1e-3


def angles(seed: int, n: int, step_deg: float, range_deg: float):
    """n angles of the turntable in degrees: a start in [-range, range]
    from the seed, then steps of step_deg that turn back at the ends."""
    rng = random.Random(seed)
    a = rng.uniform(-range_deg, range_deg)
    d = step_deg if rng.random() < 0.5 else -step_deg
    out = []
    for _ in range(n):
        out.append(a)
        if abs(a + d) > range_deg:
            d = -d
        a += d
    return out


def turned(scene: dict, deg: float) -> dict:
    """The scene with its camera turned by `deg` about the vertical axis
    through the camera's `to`."""
    cam = dict(scene["camera"])
    fx, fy, fz = (float(v) for v in cam["from"])
    tx, _, tz = (float(v) for v in cam["to"])
    r = math.hypot(fx - tx, fz - tz)
    phi = math.atan2(fx - tx, fz - tz) + math.radians(deg)
    cam["from"] = [tx + r * math.sin(phi), fy, tz + r * math.cos(phi)]
    return {**scene, "camera": cam}


def cycle_len(mix) -> int:
    """Frames before the angles repeat."""
    return max(1, int(round(4 * mix["range_deg"] / mix["step_deg"])))


def write_frames(run, folder: str):
    import yaml

    paths = []
    for k, deg in enumerate(angles(run.seed, cycle_len(run.mix),
                                   run.mix["step_deg"],
                                   run.mix["range_deg"])):
        path = os.path.join(folder, f"frame{k:04d}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(turned(run.config["scene"], deg), f)
        paths.append(path)
    for rel in run.config.get("assets", ()):
        shutil.copy(run.registry.asset_path(rel),
                    os.path.join(folder, os.path.basename(rel)))
    return paths


def setup(run):
    from rray_tpu_torch import api
    from rray_tpu_torch.config import RenderSettings

    from rtbench.harness.core import load_libraries

    st = types.SimpleNamespace(run=run, api=api)
    load_libraries(run)
    st.folder = tempfile.mkdtemp(prefix="rtbench-")
    st.paths = write_frames(run, st.folder)
    st.png = os.path.join(st.folder, "frame.png")
    cfg = run.config
    st.size = (cfg["width"], cfg["height"], run.mix["aa"])
    st.settings = RenderSettings(depth=cfg["depth"],
                                 wavefront_capacity=cfg["wavefront_capacity"])
    st.rng = random.Random(run.seed ^ 0x5eed)
    st.kept = []   # (index, image) of the reservoir
    st.last = None
    # Warm-up: the cell's one shape, through the same call as the window.
    frame(st, st.paths[-1])
    return st


def frame(st, path):
    w, h, aa = st.size
    return st.api.render_scene_from_file(path, w, h, st.png, aa=aa,
                                         settings=st.settings,
                                         device=st.run.device)


def step(st, i):
    image = frame(st, st.paths[i % len(st.paths)])
    k = st.run.mix["check_frames"]
    if len(st.kept) < k:
        st.kept.append((i, image))
    else:
        j = st.rng.randrange(i + 1)
        if j < k:
            st.kept[j] = (i, image)
    st.last = (i, image)


def reference_pixels(st, i, px, py, dtype):
    """The reference's colour [N, 3] (float64 numpy) of frame i's pixels."""
    import torch

    from rtbench.reference import whitted as rw
    from rtbench.reference.rconfig import RenderSettings

    dev = st.run.device
    path = st.paths[i % len(st.paths)]
    with open(path) as f:
        spec, scene = rw.load(f.read(), os.path.dirname(path), dtype, dev)
    w, h, aa = st.size
    cam = rw.camera(spec, w * aa, h * aa, dtype, dev)
    settings = RenderSettings(depth=st.settings.depth,
                              wavefront_capacity=st.settings.wavefront_capacity)
    out = []
    block = max(1, st.run.mix.get("check_block_rays", 1 << 20) // (aa * aa))
    with torch.no_grad():
        for b in range(0, len(px), block):
            out.append(rw.pixels(scene, cam,
                                 torch.as_tensor(px[b:b + block], device=dev),
                                 torch.as_tensor(py[b:b + block], device=dev),
                                 aa, settings).double().cpu().numpy())
    return np.concatenate(out)


def sample(st, i):
    """Output pixels (px, py) of frame i drawn from the seed."""
    w, h, _ = st.size
    from rtbench.harness import seed_words

    rng = np.random.default_rng([*seed_words(st.run.seed), i])
    flat = rng.choice(w * h, size=min(st.run.mix["check_pixels"], w * h),
                      replace=False)
    return flat % w, flat // w


def compare(st, outputs, reference):
    """Numbers from the program's outputs against the reference's:
    outputs and reference are {frame: pixels [N, 3]} plus, under "png",
    the last frame's decoded 8-bit pixels and the reference's there."""
    over, total = 0, 0
    for i, ref in reference["pixels"].items():
        d = np.abs(outputs["pixels"][i] - ref).max(axis=1)
        over += int(np.count_nonzero(~(d <= PIX_TOL)))  # NaN counts
        total += len(d)
    png = outputs["png"].astype(np.int64)
    ref8 = quantize(reference["last"])
    png_over = np.count_nonzero(np.abs(png - ref8).max(axis=1) > 1)
    return {"pix_share": over / total,
            "png_share": png_over / len(png)}


def quantize(rgb):
    """canvas.rs's `(c * 255.0) as u8`: truncation, saturated to 0..255."""
    return np.clip(np.trunc(np.nan_to_num(rgb) * 255.0), 0, 255).astype(
        np.int64)


def gather(st, dtype):
    """(program outputs, reference) at the sampled pixels of the kept
    frames; the reference computed in `dtype`."""
    from PIL import Image

    frames = dict(st.kept)
    li, limage = st.last
    frames[li] = limage
    outputs, reference = {"pixels": {}}, {"pixels": {}}
    for i, image in sorted(frames.items()):
        px, py = sample(st, i)
        outputs["pixels"][i] = np.asarray(image, np.float64)[py, px]
        reference["pixels"][i] = reference_pixels(st, i, px, py, dtype)
    px, py = sample(st, li)
    decoded = np.asarray(Image.open(st.png).convert("RGB"))
    w, h, _ = st.size
    if decoded.shape[:2] != (h, w):
        raise ValueError(f"PNG is {decoded.shape[:2]}, expected {(h, w)}")
    outputs["png"] = decoded[py, px]
    reference["last"] = reference["pixels"][li]
    return outputs, reference


def check(st, control=False):
    """The numbers; with `control`, the reference in bfloat16 stands in
    for the program (its pixels and its 8-bit values)."""
    import torch

    from rtbench.harness import reference_mode

    with reference_mode(torch, st.run.device):
        outputs, reference = gather(st, torch.float32)
        if control:
            low = {"pixels": {i: reference_pixels(
                st, i, *sample(st, i), torch.bfloat16)
                for i in reference["pixels"]}}
            low["png"] = quantize(low["pixels"][st.last[0]])
            outputs = low
        return compare(st, outputs, reference)


def close(st):
    shutil.rmtree(st.folder, ignore_errors=True)
