#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rray_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it, drives the main path
(rray_tpu_torch.api.render_scene_from_file, what the CLI calls) at
800x600 over the example scenes, four mesh scenes, five area-light
scenes (config 3, examples/area_light.yaml, also at aa=3) and two
variants of config 5, and config 5 itself (examples/csg_showcase.yaml:
CSG, a torus, Perlin noise, an image texture) at 1920x1080, aa=5,
counting each kernel's launches per scene (and the BVH trees built: one
per scene, and the triangle kernels' tables: one per scene), and times
kernels and plain versions (CUDA events; each kernel's own device time
with torch.profiler), config 5's main-path launch on its full 9600x5400
raster included, the BVH kernel's on area4b's 2.4 M-ray shadow call and
on a 49,612-triangle mesh, and the triangle kernels' on area9's 2.4
M-ray shadow call and on a 1008-triangle mesh, with the BVH kernel on
mesh9's rays beside them as a yardstick. Bounds count the least work of
every level's live path rows. Then the gradient path: at 160x120 the
kernel route's gradients (integrator.WhittedKernel) against the torch
route's and the closest-triangle Function fed by the kernels against it
fed by their plain versions, and the train phase, parallel.train's
make_train_step with torch.optim.Adam for four steps at 800x600 on
example1, glass, mesh4, mesh4b, config 3 and glass4 (one scene per
route: kernel, fast, sorted), from a corrupted pattern colour and light
intensity, with forward and backward ms and peak memory per step and
its own launch counts. Then the paths of progressive, resilient and
sharded rendering: api.render_scene_progressive on config 3 at aa=3 in
29 bands of 64 rows (29 whitted launches, the tables packed once, held
against the same bands through the kernel's plain version), glass in
bands against its one-shot frame, a frame cut by RRAY_FAIL_AFTER_BANDS
and resumed against the uninterrupted one; api.render_resilient on
example1 with every child CLI killed after two bands; two ranks on the
card over gloo (started with spawn) rendering glass, config 3, mesh4b
and glass4 with parallel.mesh.render_sharded against the single-process
frames, and one sharded Adam step of parallel.train.make_train_step on
example1 against the single-process step; and utils.profiling.trace
around a glass render, whose Chrome trace must name the whitted kernel.
Then the oracle phase: rray_tpu's per-ray reference path
(integrator.render_aos: ops/hits.py, ops/normals.py,
render/patterns.py, no kernel; it must launch none) at 800x600 in
float32 on example1, glass, mesh4 and config 5 at 1920x1080 (kernel
route), mesh9 and mesh4b (fast node), glass4 and csgglass (sorted
node), each held against the routed frame at wavefront_capacity
2^depth within rray_tpu's budget for two f32 formulations of one scene
(under 5e-3 of the pixels over 1e-3, median |diff| under 1e-6), with
the AoS frame's wall time and peak memory; and the unrolled phase:
render_scene_from_file under RenderSettings(wavefront="unrolled") at
800x600 on glass, glass4, glass21 and csgglass and at 400x300 on
glass4b (its exhaustive wavefronts' mesh fold), within 2e-6 of
the "scan" frame, B2/B3, B4 and B5 launched and the whitted kernel not.
Then the local mesh phase: parallel.mesh.render_sharded over
make_mesh(devices=[cuda:(i % n) for four entries]) (four blocks on one
card when n = 1) on glass, config 3,
mesh4b, glass4 and area21, each frame bit for bit the single-process
frame, every kernel launched, with launches and table builds per entry
and peak memory; one local-mesh Adam step on example1 against the
single-process step; and the compute API with no device argument
(compile_scene, compile_camera) rendering glass on the card. The JSON
line's launches count the main path's runs, the oracle's routed
frames, the unrolled runs, the progressive frames, both ranks' sharded
frames and the local mesh's frames, each from 0; a main-path frame
launches the box-filter kernel (kernels/downsample.py) once at aa > 1
and never at aa = 1, and the progressive frames never. The downsample
phase holds that kernel bit for bit against canvas.downsample on a
9600x5400 raster and times it beside its byte bound, its plain version
and torch.mean, for its row of the JSON line. Each main-path frame
also launches the PNG's deflate match search (kernels/deflate.py) once,
and the progressive frames never; the png phase holds its tables
against the plain version on the card and its PNG against compress2's
at both benchmark cells' sizes, and times the kernel beside its bound,
the plain version, and the host's emitter beside compress2, for its row
of the JSON line. It prints the card,
one line per phase, a JSON line describing the kernels, and last a JSON
line naming the device. Any failure exits non-zero before the last
line; without CUDA it exits 1 at once.

The generated scenes are written as YAML + OBJ into a temporary
directory by rray_tpu_torch/io/mesh_scenes.py, the writer the CPU tests
use (UV-sphere meshes; the camera, light and checker floor of rray_tpu's
mesh benchmark cells; the area scenes swap the point light for config
3's area light, level 5):

    mesh4   one 220-triangle sphere             whitted kernel, depth 0
    mesh4r  the same over a reflective floor    whitted kernel, depth 5
    mesh9   nine 60-triangle spheres, 9 colours fast node: triangle kernels
    mesh4b  one 3120-triangle sphere            fast node: BVH kernel
    area4   mesh4 under the area light          whitted kernel, stages c+d
    area21  20 spheres (5x4) over a reflective  fast node + area-shadow
            floor: 21 analytic prims            kernel, depth 5
    area4b  mesh4b under the area light         fast node: BVH any-hit
                                                per row of shadow samples
    area9   mesh9 under the area light          fast node: closest_triangle,
                                                any_triangle per row of
                                                shadow samples
    mesh9k  nine 112-triangle spheres           triangle kernels alone,
                                                1008 triangles
    mesh50b one 49,612-triangle sphere          BVH kernel alone, tables
                                                past shared memory
    area801 800 spheres over a reflective       area-shadow kernel alone,
            floor, area light                   prim rows past 327
    csg5r   config 5, a perturbed stripe on the whitted kernel, stages c+e,
            torus, reflective floor, the area   depth 5
            light
    tex5r   config 5, the CSG split into its    fast node (textured and
            operands, reflective floor          reflective), depth 5
    glass4  mesh4's sphere as glass, lifted     sorted node: compact
            0.01 off the floor                  wavefront at W = 4,
                                                closest_triangle and
                                                any_triangle, the chunked
                                                n1/n2 mesh fold
    glass4b mesh4b's sphere as glass            sorted node: BVH kernel
                                                (closest and any-hit)
    glass21 area21 with every other sphere      sorted node: area-shadow
            glass                               kernel at every live level
    csgglass config 5, the CSG's right operand  sorted node: the hybrid
            at transparency 0.5 (1920x1080)     CSG path, n1/n2 from the
                                                filtered operand slots
    csgmesh config 5, a tetrahedron OBJ as the  sorted node: full sorted
            CSG's right operand (1920x1080)     slots, no kernel (as in
                                                rray_tpu: torch folds)

The sorted node's scenes are held against the same render with the
plain versions of the triangle, BVH and area-shadow kernels on the card
(plain_kernels()), and their frames are timed on the main path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 800, 600
DEVICE = "cuda"
EXAMPLES = (("glass", "examples/glass.yaml"),
            ("example1", "examples/example1.yaml"),
            ("area", "examples/area_light.yaml"),
            ("csg", "examples/csg_showcase.yaml"))
# Config 5 and its sorted-node variants render at its BASELINE size, the
# other scenes at 800x600.
SIZES = {"csg": (1920, 1080), "csgglass": (1920, 1080),
         "csgmesh": (1920, 1080)}
# The aa=5 raster of config 5 (51.84 M rays) is held against the plain
# version on every CSG_STRIDE-th ray (1.08 M rays).
CSG_STRIDE = 48
# Whole images, kernel vs plain version in float32 on the card: at most
# this fraction of pixels may differ by more than PIX_TOL in some
# channel (rsqrtf/powf ulps can flip a shadow or n1/n2 boundary
# decision), and no pixel by more than MAX_TOL (one u8 step).
PIX_TOL = 1e-4
FRAC_TOL = 1e-3
MAX_TOL = 1.0 / 255.0
# Triangle kernels vs plain versions: the same winning triangle on at
# least IDX_SHARE of the rays (a box cull flipped by a rounding at a box
# face may drop a grazing hit); where the winner agrees, t, u, v within
# HIT_TOL * max(1, |t|), the normal within HIT_TOL * max(1, |n|) and the
# aux payload (prim id, shade class) equal; any-hit flags equal on at
# least ANY_SHARE.
IDX_SHARE = 0.999
HIT_TOL = 1e-5
ANY_SHARE = 0.9999
# The area-shadow kernel vs its plain version: the same fraction on at
# least this share of origins (both count integer-exact draws; only a
# sqrtf or division ulp at a shadow boundary could flip a sample).
AREA_SHARE = 0.9999
# Timing windows: at least this much device time per window, in turns
# plain, kernel, kernel, plain.
WINDOW_MS = 200.0
# The card's peaks for the least-time bound (NVIDIA's H100 SXM data
# sheet): HBM bandwidth, the FP32 rate outside the tensor cores, and the
# INT32 rate (half the FP32 rate on Hopper) for the jitter hash.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
PEAK_INT_PER_S = 33.5e12
# Float operations per test, counted from the device code: a ray-prim
# slot test is the world->object affine of origin and direction (36)
# plus the slot form (~24, sphere/plane); a shadow occlusion test the
# same affine plus ~20; a ray-triangle test is Moller-Trumbore (~50:
# 9+5 cross/det, 1 div, 3+6 u, 9+6 q/v, 6 t, ~11 compares and sums).
OPS_PRIM, OPS_OCCLUDE, OPS_TRI = 60, 56, 50
# The area-shadow function's least work splits an occlusion test: the
# origin's object-space point (affine of a point, 18) once per origin
# and prim, then per sample the direction's affine (15) and the ~20 of
# the slot form.
OPS_ORIGIN_AFFINE = 18
OPS_SEGMENT_TEST = OPS_OCCLUDE - OPS_ORIGIN_AFFINE
# An area-light shadow sample, counted from jitter_device.cuh and
# area_sample: the hash base per origin (3 fmix32 of 8 integer ops, 3
# products, 3 xors: 30), two draws per sample (xor, product, fmix32,
# shift: 11 integer ops and a convert each), and the sample's segment
# (ur/vr 2 adds, 2 divides, 2 products; position 12; segment 3; length
# 5 + sqrt; 1/max 2; direction 3: ~30 float ops).
OPS_HASH_BASE, OPS_SAMPLE_INT, OPS_SAMPLE_FP = 30, 24, 30
# Stage e, counted from quartic_device.cuh, whitted_device.cuh and
# noise_device.cuh: the torus's slab test against its padded box (3
# reciprocals, 6 products, 6 sums, 9 min/max: ~30); its quartic where a
# ray enters the box (coefficients ~30; resolvent and Ferrari ~90, with
# acos, cos and two cbrt evaluated in double at ~20 each; three Newton
# steps on four roots at ~20: ~400); a CSG pair compare (the t compare,
# the parity xor, the and: 3); a Perlin octave (3 floors, 3 quintics of
# 7, 8 gradient dots of 3, 7 lerps of 3, frequency products: ~90 float;
# lattice products and 8 hashes of ~15: ~130 integer).
OPS_TORUS_BOX, OPS_QUARTIC, OPS_CSG_PAIR = 30, 400, 3
OPS_OCTAVE_FP, OPS_OCTAVE_INT = 90, 130
# Rays per step of the least-work count ([RAY_STEP, T] temporaries).
RAY_STEP = 8192


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# The generated scenes: rray_tpu_torch/io/mesh_scenes.py write_scene
# arguments, by name.
SCENES = {
    "mesh4": dict(lat_lon=(11, 11)),
    "mesh4r": dict(lat_lon=(11, 11), reflective=0.3),
    "mesh9": dict(lat_lon=(6, 6), grid=True),
    "mesh4b": dict(lat_lon=(40, 40)),
    "area4": dict(lat_lon=(11, 11), area_level=5),
    "area21": dict(lat_lon=None, spheres=20, reflective=0.3, area_level=5),
    "area4b": dict(lat_lon=(40, 40), area_level=5),
    "area9": dict(lat_lon=(6, 6), grid=True, area_level=5),
    "glass4": dict(lat_lon=(11, 11), glass=True),
    "glass4b": dict(lat_lon=(40, 40), glass=True),
    "glass21": dict(lat_lon=None, spheres=20, reflective=0.3, area_level=5,
                    glass=True),
}
# Scenes of the kernel phases only: mesh_scenes.write_scene arguments.
PHASE_SCENES = {
    "mesh9k": dict(lat_lon=(8, 8), grid=True),
    "mesh50b": dict(lat_lon=(158, 158)),
    "area801": dict(lat_lon=None, spheres=800, reflective=0.3, area_level=5),
}
# Config 5's variants: mesh_scenes.write_config5 arguments, by name.
CONFIG5 = {
    "csg5r": dict(floor_reflective=0.3, area_level=5, perturbed_torus=True),
    "tex5r": dict(floor_reflective=0.3, split_csg=True),
    "csgglass": dict(transparent_operand=0.5),
    "csgmesh": dict(mesh_operand=True),
}
# The sorted node's scenes, in the order of their main-path runs, and
# those whose plain-kernel comparison renders at half size.
SORTED = ("glass4", "glass4b", "glass21", "csgglass", "csgmesh")
HALF_SIZE_PLAIN = ("glass4b", "glass21")
# The train phase: make_train_step with torch.optim.Adam on these scenes
# at 800x600, aa=1 (routes kernel x4, fast, sorted), TRAIN_STEPS steps
# each from a corrupted pattern colour and light intensity; the kernels
# its forward passes and its backward recomputes must launch.
TRAIN_SCENES = ("example1", "glass", "mesh4", "mesh4b", "area", "glass4")
TRAIN_STEPS = 4
TRAIN_KERNELS = ("whitted_compact", "closest_triangle", "any_triangle",
                 "bvh_closest_triangle", "area_shadow_fraction")
# Gradient parity at GRAD_SIZE on the card, float32. The kernel route
# (WhittedKernel: the whitted kernel forward, reference_node recomputed
# backward) against reference_node under autograd: rray_tpu's bound for
# its kernel against its XLA gradients in f32 (tests/test_wavefront.py
# test_gradients_match_xla_path: rtol 0.05, atol 1e-4), since the loss
# weights each pixel by the forward's own value and an area sample
# keyed on an over point one ulp away draws other jitter. The
# closest-triangle Function fed by the kernels against it fed by their
# plain versions: the same winners (IDX_SHARE) and index_add_ in another
# order, CLOSEST_TOL of each table's largest gradient.
GRAD_SIZE = (160, 120)
GRAD_RTOL, GRAD_ATOL = 0.05, 1e-4
CLOSEST_TOL = 1e-3


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------

def card_state():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def size_of(name):
    return SIZES.get(name, (WIDTH, HEIGHT))


def camera_scene(path, torch, aa=1, size=(WIDTH, HEIGHT)):
    """(compiled scene, camera rays) at size * aa, as the main path sizes
    its camera."""
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.render.camera import (Camera, all_rays_soa,
                                              compile_camera)
    from rray_tpu_torch.scene.data import compile_scene

    cam_spec, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=DEVICE)
    cam = Camera(size[0] * aa, size[1] * aa, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    return scene, all_rays_soa(compile_camera(cam, torch.float32, DEVICE))


def camera_data(path, torch, size=(WIDTH, HEIGHT)):
    """(compiled scene, CameraData) at `size` on the card."""
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.render.camera import Camera, compile_camera
    from rray_tpu_torch.scene.data import compile_scene

    cam_spec, lights, shapes = load_scene_file(path)
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=DEVICE)
    cam = Camera(size[0], size[1], cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    return scene, compile_camera(cam, torch.float32, DEVICE)


def window_ms(torch, fn):
    """(mean ms per call over a window of at least WINDOW_MS of device
    time (CUDA events), the window's call count), after a warm-up call.
    For a wrapper whose host work outlasts its kernel, this is the
    call's host time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(stop)
    if first >= WINDOW_MS:  # one call fills the window
        return first, 1
    reps = math.ceil(WINDOW_MS / max(first, 1e-3))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, reps


def kernel_ms(torch, fn, kernel, reps):
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`, over `reps` calls of `fn` (torch.profiler, CUPTI): the
    kernel alone, without the wrapper's host work and table packing."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in prof.key_averages() if kernel in e.key)
    if total <= 0:
        fail(f"the profiler saw no device time for {kernel}")
    return total / 1e3 / reps


def timed_turns(torch, what, kernel, kernel_fn, plain_fn):
    """Times in turns plain, kernel, kernel, plain -> (kernel device ms
    per launch, wrapper call ms, plain ms), each the mean of its two
    turns; prints every turn with the card's SM clock and power limit."""
    times = {"plain": [], "call": [], "kernel": []}
    for side in ("plain", "kernel", "kernel", "plain"):
        if side == "plain":
            ms, _ = window_ms(torch, plain_fn)
            times["plain"].append(ms)
            print(f"time {what} plain: {ms:.5f} ms [{card_state()}]")
            continue
        call, reps = window_ms(torch, kernel_fn)
        ms = kernel_ms(torch, kernel_fn, kernel, reps)
        times["call"].append(call)
        times["kernel"].append(ms)
        print(f"time {what} kernel: {ms:.5f} ms on the device, call "
              f"{call:.5f} ms ({reps} calls) [{card_state()}]")
    return tuple(sum(times[k]) / 2 for k in ("kernel", "call", "plain"))


def compare_images(torch, kernel_rgb, plain_rgb, what):
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
    return max_abs


def compare_hits(torch, kern, plain, n_aux, what):
    """Triangle-kernel outputs (t, u, v, idx[, n][, aux]; the last
    `n_aux` are aux columns) vs the plain version's -> max |diff| over
    the float outputs where the winner agrees."""
    same = kern[3] == plain[3]
    share = float(same.double().mean())
    first_aux = len(plain) - n_aux
    worst = 0.0
    for k, (a, b) in enumerate(zip(kern, plain)):
        if k == 3:
            continue
        both_inf = torch.isinf(a) & torch.isinf(b) & ((a > 0) == (b > 0))
        d = torch.where(same & ~both_inf, (a - b).abs(), 0.0)
        scale = plain[0] if k < 3 else b
        tol = HIT_TOL * torch.clamp_min(scale.abs(), 1.0)
        tol = torch.where(torch.isfinite(tol), tol, HIT_TOL)
        if k >= first_aux:
            tol = torch.zeros_like(tol)
        if bool((d > tol).any()):
            fail(f"{what}: output {k} differs by {float(d.max()):.3e} "
                 f"where the winner agrees (limit "
                 f"{'0' if k >= first_aux else f'{HIT_TOL} * max(1, |x|)'})")
        worst = max(worst, float(d.max()))
    if share < IDX_SHARE:
        fail(f"{what}: the winning triangle agrees on {share:.6f} of rays "
             f"(limit {IDX_SHARE})")
    print(f"parity {what}: winner equal on {share:.6f} of rays, max "
          f"|kernel - plain| {worst:.3e} where it is")
    return worst


def compare_fractions(torch, kern, plain, what):
    """Area-shadow fractions: equal on at least AREA_SHARE of origins ->
    max |diff|."""
    if not bool(torch.isfinite(kern).all()):
        fail(f"{what}: the kernel produced non-finite values")
    share = float((kern == plain).double().mean())
    max_abs = float((kern - plain).abs().max())
    if share < AREA_SHARE:
        fail(f"{what}: fractions equal on {share:.6f} of origins (limit "
             f"{AREA_SHARE}), max |diff| {max_abs:.3e}")
    print(f"parity {what}: fractions equal on {share:.6f} of origins, max "
          f"|kernel - plain| {max_abs:.3e}, mean fraction "
          f"{float(plain.mean()):.4f}")
    return max_abs


def compare_flags(torch, kern, plain, what):
    share = float((kern == plain).double().mean())
    if share < ANY_SHARE:
        fail(f"{what}: any-hit flags equal on {share:.6f} (limit "
             f"{ANY_SHARE})")
    print(f"parity {what}: flags equal on {share:.6f} of rays, "
          f"{float(plain.double().mean()):.4f} occluded")
    return float((kern != plain).double().max())


def triangle_tests(torch, rays, geom, bound):
    """Moller-Trumbore tests the function needs at least, counted per
    triangle, a granularity no kernel chooses: for each ray, every
    triangle whose own AABB it enters at or before `bound` (its final
    closest t, or its shadow distance; -inf counts nothing)."""
    from rray_tpu_torch.kernels import triangles

    boxes = triangles.chunk_boxes(geom[:9], 1)[:, :-1]
    total = 0
    for r0 in range(0, rays[0][0].shape[0], RAY_STEP):
        o = [c[r0:r0 + RAY_STEP, None] for c in rays[0]]
        d = [c[r0:r0 + RAY_STEP] for c in rays[1]]
        inv = [(1.0 / torch.where(c.abs() < 1e-30,
                                  torch.where(c < 0, -1e-30, 1e-30), c))[:, None]
               for c in d]
        lo = [(boxes[j][None, :] - o[j]) * inv[j] for j in range(3)]
        hi = [(boxes[3 + j][None, :] - o[j]) * inv[j] for j in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(lo[0], hi[0]),
                                           torch.minimum(lo[1], hi[1])),
                             torch.minimum(lo[2], hi[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(lo[0], hi[0]),
                                           torch.maximum(lo[1], hi[1])),
                             torch.maximum(lo[2], hi[2]))
        enter = ((tmin <= tmax) & (tmax >= 0.0)
                 & (tmin <= bound[r0:r0 + RAY_STEP, None]))
        total += int(enter.sum())
    return total


def bound_ms(n_bytes, n_ops, n_int=0):
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over their rate (float at the FP32 rate,
    integer at the INT32 rate) -> (ms, which bounds it, a line giving
    both terms)."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (n_ops / PEAK_FLOP_PER_S + n_int / PEAK_INT_PER_S) * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations",
            f"bytes {by_bytes:.6f} ms, operations {by_ops:.6f} ms")


@contextlib.contextmanager
def plain_kernels():
    """Route the fast node's kernel calls (triangle, BVH, area shadow) to
    the plain versions on the card, to render its plain image (kernel
    calls made meanwhile would not count: none are)."""
    from rray_tpu_torch.kernels import analytic, bvh, triangles

    def plain(fn):
        return lambda *a, **k: fn(*a, **{key: v for key, v in k.items()
                                         if key != "tables"}, chunk=128)

    saved = (triangles.closest_triangle, triangles.any_triangle,
             bvh.bvh_closest_triangle, analytic.area_shadow_fraction)
    triangles.closest_triangle = plain(triangles.closest_triangle_reference)
    triangles.any_triangle = plain(triangles.any_triangle_reference)
    bvh.bvh_closest_triangle = plain(bvh.bvh_closest_triangle_reference)
    analytic.area_shadow_fraction = analytic.area_shadow_fraction_reference
    try:
        yield
    finally:
        (triangles.closest_triangle, triangles.any_triangle,
         bvh.bvh_closest_triangle, analytic.area_shadow_fraction) = saved


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def tree_work(descr):
    """(Perlin octaves, texel reads) of one evaluation of a pattern tree
    (pack_patterns' descriptor): three fBm calls per perturbed node."""
    if descr is None:
        return 0, 0
    ptype, _, meta, da, db = descr
    octaves = {"noise": meta, "perturbed": 3 * meta}.get(ptype, 0)
    sub = [tree_work(c) for c in (da, db)]
    return (octaves + sum(o for o, _ in sub),
            int(ptype == "image") + sum(t for _, t in sub))


def node_work(torch, inputs, o, d, seeds, mesh=None, geom=None):
    """Least work of one Whitted node on the rays (o, d) -> (float ops,
    integer ops, counts). Every ray tests every analytic prim (a torus
    its box, and its quartic where the ray enters the box; the CSG
    members their slots, then the pair compares of every CSG pass) and
    every mesh triangle whose own AABB it enters before its closest hit.
    Every hit evaluates the Perlin octaves of its winner's pattern tree,
    reads its texel (4 B packed) and, per point light or area-light
    sample (drawn with `seeds`, this level's seed per light), tests its
    shadow segment: one occlusion test when it is blocked, else every
    prim as a primary ray does (an occlusion test for a plain prim) and
    every triangle whose AABB it enters before the light. `mesh` and
    `geom` are the plain version's mesh and the triangles' p1 e1 e2."""
    from rray_tpu_torch.kernels import analytic, whitted
    from rray_tpu_torch.ops import jitter, soa
    from rray_tpu_torch.ops.vec import V3
    from rray_tpu_torch.scene import data as sd

    kinds, prims = inputs["kinds"], inputs["prim_tbl"].tolist()
    csg = inputs.get("csg", ((), ()))
    member = csg[0] or (False,) * len(kinds)
    n_slots = sum(whitted.SLOTS_PER_KIND[k] for k, m in zip(kinds, member)
                  if m)
    pair_ops = len(csg[1]) * n_slots * (n_slots - 1) * OPS_CSG_PAIR
    counts = dict.fromkeys(("hits", "quartics", "shadow_quartics", "octaves",
                            "texels", "samples", "blocked",
                            "triangle_tests"), 0)

    def tests(o, d, occ=None):
        """Float ops of a primary ray's prim tests, or of a shadow
        segment's (blocked where `occ`), summed over the rays."""
        ops = torch.full_like(o.x, float(pair_ops), dtype=torch.float64)
        for k, p, m in zip(kinds, prims, member):
            if k == sd.TORUS:
                enter = soa.torus_box_entry(whitted._affine_pt(p, o),
                                            whitted._affine_vec(p, d), p[31])
                if occ is not None:
                    enter = enter & ~occ
                counts["quartics" if occ is None
                       else "shadow_quartics"] += int(enter.sum())
                ops = ops + OPS_TORUS_BOX + OPS_QUARTIC * enter.double()
            else:
                ops = ops + (OPS_OCCLUDE if occ is not None and not m
                             else OPS_PRIM)
        if occ is not None:
            ops = torch.where(occ, float(OPS_OCCLUDE), ops)
        return float(ops.sum())

    def shadow(over, direction, dist):
        occ = whitted._blocked(kinds, prims, mesh, over, direction.x,
                               direction.y, direction.z, dist, csg)
        counts["blocked"] += int(occ.sum())
        ops = tests(over, direction, occ)
        if geom is not None:
            tri = triangle_tests(
                torch, ((over.x, over.y, over.z),
                        (direction.x, direction.y, direction.z)), geom,
                torch.where(occ, -math.inf, dist))
            counts["triangle_tests"] += tri
            ops += tri * OPS_TRI
        return ops

    n_ops = tests(o, d)
    best_t, win = whitted.closest_hit(kinds, prims, mesh, o, d, csg)[:2]
    if geom is not None:
        tri = triangle_tests(torch, ((o.x, o.y, o.z), (d.x, d.y, d.z)), geom,
                             best_t)
        counts["triangle_tests"] += tri
        n_ops += tri * OPS_TRI
    found = torch.isfinite(best_t)
    hits = counts["hits"] = int(found.sum())
    for i, root in enumerate(inputs["prim_pat"]):
        n_i = int((win == i).sum())
        oc, tx = tree_work(inputs["pat_descrs"][root])
        counts["octaves"] += n_i * oc
        counts["texels"] += n_i * tx
    n_ops += counts["octaves"] * OPS_OCTAVE_FP
    n_int = counts["octaves"] * OPS_OCTAVE_INT
    levels, lights = inputs["light_levels"], inputs["light_tbl"].tolist()
    over = whitted._node(
        kinds, inputs["pat_descrs"], inputs["prim_pat"], inputs["has_refl"],
        inputs["has_refr"], prims, inputs["pat_tbl"].tolist(), lights,
        levels, seeds, mesh, o, d, csg, tex_of(inputs))[1]
    over = V3(over.x[found], over.y[found], over.z[found])
    for L, level, seed in zip(lights, levels, seeds):
        if level == 0:
            to = V3(L[0] - over.x, L[1] - over.y, L[2] - over.z)
            dist = to.norm()
            n_ops += shadow(over, to * (1.0 / torch.clamp_min(dist, 1e-30)),
                            dist)
            continue
        hb = jitter.point_base(seed, over.x, over.y, over.z)
        for k in range(level * level):
            direction, dist = analytic.area_sample(L[6:15], hb, k, level, over)
            n_ops += shadow(over, direction, dist)
        counts["samples"] += hits * level * level
        n_int += hits * OPS_HASH_BASE + hits * level * level * OPS_SAMPLE_INT
        n_ops += hits * level * level * OPS_SAMPLE_FP
    return n_ops, n_int, counts


def tex_of(inputs):
    """The plain version's texture argument of kernel_inputs' dict."""
    return ((inputs["tex_tbl"], inputs["tex_meta"]) if "tex_tbl" in inputs
            else None)


def level_rows(torch, inputs, ro, rd, mesh):
    """The path rows of nonzero weight at every level of the plain
    version's level scan (whitted_compact_reference's loop, run again with
    its node: W rows per ray, children of both kinds sorted by weight,
    the first W kept) -> [(o, d)] per level."""
    from rray_tpu_torch.kernels import whitted
    from rray_tpu_torch.ops.vec import V3

    depth, W = inputs["depth"], inputs["W"]
    has_refl, has_refr = inputs["has_refl"], inputs["has_refr"]
    spawn = 2 if has_refl and has_refr else int(has_refl or has_refr)
    R = ro.x.shape[0]
    st = torch.zeros((7, W, R), dtype=ro.x.dtype, device=ro.x.device)
    st[5] = 1.0
    for c, v in enumerate((ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)):
        st[c, 0] = v
    st[6, 0] = 1.0
    out = []
    for level in range(depth + 1):
        rows = st.reshape(7, W * R)
        live = rows[6] != 0.0
        out.append((V3(*(rows[c][live] for c in range(3))),
                    V3(*(rows[c][live] for c in range(3, 6)))))
        if level == depth or not spawn:
            break
        _, over, under, reflectv, refr_dir, refl_w, refr_w = whitted._node(
            inputs["kinds"], inputs["pat_descrs"], inputs["prim_pat"],
            has_refl, has_refr, inputs["prim_tbl"].tolist(),
            inputs["pat_tbl"].tolist(), inputs["light_tbl"].tolist(),
            inputs["light_levels"], inputs["seeds"][level].tolist(), mesh,
            V3(rows[0], rows[1], rows[2]), V3(rows[3], rows[4], rows[5]),
            inputs.get("csg", ((), ())), tex_of(inputs))
        w = rows[6]
        children = [(over, reflectv, w * refl_w), (under, refr_dir,
                                                  w * refr_w)]
        if spawn == 1:
            children = children[:1] if has_refl else children[1:]
        ch = torch.stack([
            torch.cat([(pt.x, pt.y, pt.z, dr.x, dr.y, dr.z, cw)[c]
                       .reshape(W, R) for pt, dr, cw in children])
            for c in range(7)])
        if spawn == 2:
            order = torch.sort(ch[6], dim=0, descending=True,
                               stable=True).indices[:W]
            ch = torch.gather(ch, 1, order.expand(7, W, R))
        st = ch[:, :W].contiguous()
    return out


def whitted_work(torch, name, inputs, ro, rd, chunk=None):
    """Least work of the whitted kernel on camera rays, counted on every
    level's live path rows (level_rows), `chunk` rays at a time -> (bound
    over all levels, bound of the primary level alone), each bound_ms's
    triple. Bytes: rays in and RGB out, the tables once, each texel read
    once."""
    from rray_tpu_torch.ops.vec import V3

    mesh = geom = None
    if "tri_tbl" in inputs:
        cols = inputs["tri_tbl"].unbind(1)
        mesh = (cols[:18], cols[18])
        geom = tuple(c.contiguous() for c in cols[:9])
    R = ro.x.shape[0]
    chunk = chunk or R
    per_level = {}
    for c0 in range(0, R, chunk):
        o = V3(*(c[c0:c0 + chunk] for c in (ro.x, ro.y, ro.z)))
        d = V3(*(c[c0:c0 + chunk] for c in (rd.x, rd.y, rd.z)))
        for level, (lo, ld) in enumerate(level_rows(torch, inputs, o, d,
                                                    mesh)):
            ops, ints, counts = node_work(
                torch, inputs, lo, ld, inputs["seeds"][level].tolist(), mesh,
                geom)
            acc = per_level.setdefault(level, dict(rows=0, ops=0.0, ints=0))
            acc["rows"] += lo.x.shape[0]
            acc["ops"] += ops
            acc["ints"] += ints
            for k, v in counts.items():
                acc[k] = acc.get(k, 0) + v
    for level, acc in per_level.items():
        print(f"work whitted {name} level {level}: {acc['rows']} live rows, "
              f"{acc['hits']} hits, quartics {acc['quartics']} primary and "
              f"{acc['shadow_quartics']} in shadow tests, {acc['octaves']} "
              f"noise octaves, {acc['texels']} texel reads, {acc['samples']} "
              f"area samples ({acc['blocked']} shadow segments blocked), "
              f"{acc['triangle_tests']} triangle tests")
    texels = sum(acc["texels"] for acc in per_level.values())
    n_bytes = 4 * (9 * R + inputs["seeds"].numel() + texels + sum(
        inputs[k].numel() for k in ("prim_tbl", "pat_tbl", "light_tbl",
                                    "tri_tbl", "tri_boxes") if k in inputs))
    ops = sum(acc["ops"] for acc in per_level.values())
    ints = sum(acc["ints"] for acc in per_level.values())
    return (bound_ms(n_bytes, ops, ints),
            bound_ms(n_bytes, per_level[0]["ops"], per_level[0]["ints"]))


def whitted_phase(torch, name, path, results, aa=1, stride=1):
    """The whitted kernel against its plain version on one scene's camera
    rays at its size times aa, with the raster width as the main path
    passes it (every `stride`-th ray, without it); with stride 1 also
    the least work of every level for the bound."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import whitted
    from rray_tpu_torch.ops.vec import V3

    w, h = size_of(name)
    scene, (ro, rd) = camera_scene(path, torch, aa, (w, h))
    label = f"{w * aa}x{h * aa}"
    raster = {"width": w * aa}
    if stride > 1:
        ro, rd = (V3(*(c[::stride].contiguous() for c in (v.x, v.y, v.z)))
                  for v in (ro, rd))
        label += f", every {stride}th ray ({ro.x.shape[0]} rays)"
        raster = {}
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    kern = whitted.whitted_compact(*rays, **inputs, **raster)
    plain = whitted.whitted_compact_reference(*rays, **inputs)
    torch.cuda.synchronize()
    max_abs = compare_images(torch, kern, plain, f"{name} {label}")
    print(f"parity whitted {name} {label} (depth {inputs['depth']}, W "
          f"{inputs['W']}, {scene.counts[6]} triangles, light levels "
          f"{inputs['light_levels']}, stage e {whitted.needs_ext(scene)}): "
          f"max |kernel - plain| {max_abs:.3e}")
    entry = dict(rays=rays, inputs=inputs, raster=raster, plain=plain,
                 max_abs=max_abs, aa=aa, size=(w, h), timed=stride == 1)
    results.setdefault("whitted", {})[
        name if stride == 1 else f"{name} aa={aa} subset"] = entry
    if stride == 1:
        entry["bound"], entry["bound_primary"] = whitted_work(
            torch, name, inputs, ro, rd)


def main_launch_phase(torch, path, results, aa=5, chunk=1920 * 1080):
    """Config 5's main-path launch at full size: the whitted kernel alone
    on the 9600x5400 raster (51.84 M rays, with the raster width), its
    device time (torch.profiler) and call time (CUDA events); the plain
    version on the same rays `chunk` at a time (its time summed over the
    calls, and its image held against the kernel's); the least work of
    all the rays for the bound."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import whitted

    w, h = size_of("csg")
    scene, (ro, rd) = camera_scene(path, torch, aa, (w, h))
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    inputs = whitted.kernel_inputs(scene, RenderSettings())
    fn = functools.partial(whitted.whitted_compact, *rays, **inputs,
                           width=w * aa)
    call, reps = window_ms(torch, fn)
    ms = kernel_ms(torch, fn, "whitted_kernel", reps)
    launch = dict(whitted.last_launch)
    kern = fn()
    R = ro.x.shape[0]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    plain_ms = max_abs = 0.0
    for c0 in range(0, R, chunk):
        part = tuple(tuple(c[c0:c0 + chunk] for c in v) for v in rays)
        start.record()
        plain = whitted.whitted_compact_reference(*part, **inputs)
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        max_abs = max(max_abs, compare_images(
            torch, tuple(k[c0:c0 + chunk] for k in kern), plain,
            f"csg {w * aa}x{h * aa} rays {c0}:{c0 + chunk}"))
    del kern, plain
    bound, primary = whitted_work(torch, f"csg {w * aa}x{h * aa}", inputs,
                                  ro, rd, chunk)
    print(f"parity whitted csg {w * aa}x{h * aa} (the main path's launch, "
          f"every ray, plain version in {math.ceil(R / chunk)} calls): max "
          f"|kernel - plain| {max_abs:.3e}")
    print(f"time whitted_compact csg {w * aa}x{h * aa} aa={aa} (the main "
          f"path's launch): kernel {ms:.4f} ms on the device ({reps} "
          f"launches, {R / ms * 1e3:.4g} primary rays/s), call {call:.4f} "
          f"ms, plain {plain_ms:.1f} ms ({math.ceil(R / chunk)} calls), "
          f"bound {bound[0]:.5f} ms ({bound[2]}), {launch['blocks_per_sm']} "
          f"blocks/SM, {launch['smem']} B dynamic shared memory "
          f"[{card_state()}]")
    results["whitted main"] = dict(ms=ms, call_ms=call, plain_ms=plain_ms,
                                   bound=bound, max_abs=max_abs)


def area_work(torch, args):
    """Least work of area_shadow_fraction on these inputs -> (float ops,
    integer ops, counts, the PR 3 count's float ops): every origin's hash
    base and every sample's draws and segment; a blocked sample one
    occlusion test; an open sample a test of every prim its segment
    enters (its padded world box, analytic.occluder_bounds; unbounded
    prims always), the origin's
    object-space point once per origin and prim so tested. PR 3 counted
    P full occlusion tests per open sample."""
    from rray_tpu_torch.kernels import analytic
    from rray_tpu_torch.ops import jitter
    from rray_tpu_torch.ops.vec import V3

    over, seed, light, params, kinds, level = args[:6]
    R, P, n = over[0].shape[0], len(kinds), level * level
    box = analytic.occluder_bounds(params, kinds)
    lo, hi, bounded = box[:, :3], box[:, 3:6], box[:, 6] != 0
    o = V3(*over)
    hb = jitter.point_base(seed, o.x, o.y, o.z)
    cuv, rows = light.tolist(), params.tolist()
    counts = dict(blocked=0, segment_tests=0, origin_prims=0)
    for r0 in range(0, R, RAY_STEP * 8):
        oc = V3(*(c[r0:r0 + RAY_STEP * 8] for c in over))
        hc = hb[r0:r0 + RAY_STEP * 8]
        tested = torch.zeros((oc.x.shape[0], P), dtype=torch.bool,
                             device=DEVICE)
        for s in range(n):
            d, dist = analytic.area_sample(cuv, hc, s, level, oc)
            occ = torch.zeros_like(oc.x, dtype=torch.bool)
            for kind, p in zip(kinds, rows):
                occ = occ | analytic._occludes(kind, p.__getitem__, oc.x,
                                               oc.y, oc.z, d.x, d.y, d.z, dist)
            inv = [1.0 / torch.where(c.abs() < 1e-30,
                                     torch.where(c < 0, -1e-30, 1e-30), c)
                   for c in (d.x, d.y, d.z)]
            oo = (oc.x, oc.y, oc.z)
            t1 = [(lo[None, :, j] - oo[j][:, None]) * inv[j][:, None]
                  for j in range(3)]
            t2 = [(hi[None, :, j] - oo[j][:, None]) * inv[j][:, None]
                  for j in range(3)]
            tmin = torch.stack([torch.minimum(a, b) for a, b in zip(t1, t2)]
                               ).amax(0)
            tmax = torch.stack([torch.maximum(a, b) for a, b in zip(t1, t2)]
                               ).amin(0)
            enter = ((tmin <= tmax) & (tmax >= 0.0) & (tmin < dist[:, None])
                     | ~bounded[None, :]) & ~occ[:, None]
            counts["blocked"] += int(occ.sum())
            counts["segment_tests"] += int(enter.sum())
            tested |= enter
        counts["origin_prims"] += int(tested.sum())
    samples = R * n
    n_ops = (samples * OPS_SAMPLE_FP + counts["blocked"] * OPS_OCCLUDE
             + counts["segment_tests"] * OPS_SEGMENT_TEST
             + counts["origin_prims"] * OPS_ORIGIN_AFFINE)
    old_ops = (samples * OPS_SAMPLE_FP + counts["blocked"] * OPS_OCCLUDE
               + (samples - counts["blocked"]) * P * OPS_OCCLUDE)
    n_int = R * OPS_HASH_BASE + samples * OPS_SAMPLE_INT
    return n_ops, n_int, counts, old_ops


def area_phase(torch, name, path, results, size=(WIDTH, HEIGHT),
               timed=True):
    """The area-shadow kernel (B5) against its plain version on the
    inputs the fast node gives it at the primary level of one scene: its
    first call's origins, seed, light and prim rows (camera rays at
    `size`)."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import analytic
    from rray_tpu_torch.ops import jitter
    from rray_tpu_torch.render import integrator

    scene, (ro, rd) = camera_scene(path, torch, size=size)
    calls = []
    kernel = analytic.area_shadow_fraction
    analytic.area_shadow_fraction = lambda *a, **k: calls.append(
        a + (k["bounds"],)) or kernel(*a, **k)
    try:
        integrator._fast_node_eval(
            scene, ro, rd, RenderSettings(),
            jitter.seed_table(0, 0, len(scene.lights))[0].tolist())
    finally:
        analytic.area_shadow_fraction = kernel
    if not calls:
        fail(f"{name}: the fast node made no area-shadow call")
    args = calls[0]
    fn = functools.partial(analytic.area_shadow_fraction, *args)
    plain_fn = functools.partial(analytic.area_shadow_fraction_reference,
                                 *args)
    kern, plain = fn(), plain_fn()
    torch.cuda.synchronize()
    err = compare_fractions(torch, kern, plain, f"area_shadow_fraction {name}")
    if not timed:
        return
    # Bytes: origins in, fraction out, the light and prim rows.
    over, _, _, params, kinds, level = args[:6]
    R, P = over[0].shape[0], len(kinds)
    n_ops, n_int, counts, old_ops = area_work(torch, args)
    n_bytes = 4 * (4 * R + params.numel() + 9 + P)  # the function's inputs
    old = bound_ms(n_bytes, old_ops, n_int)
    print(f"work area_shadow_fraction {name}: {R} origins, {P} prims, "
          f"{R * level * level} samples, {counts['blocked']} blocked, "
          f"{counts['segment_tests']} open segment-prim tests where the "
          f"segment enters the prim's bounds, {counts['origin_prims']} "
          f"origin-prim transforms; PR 3's count {old[0]:.5f} ms "
          f"({old[2]})")
    results.setdefault("area_shadow_fraction", []).append(dict(
        what=name, fn=fn, plain_fn=plain_fn, max_abs=err,
        bound=bound_ms(n_bytes, n_ops, n_int)))


def shadow_call_phase(torch, name, path, results):
    """The fast node's any-hit kernel (B3 below bvh_min_tris triangles,
    else B4) on the first any-hit call it makes for an area light over a
    mesh (one row of level samples for every origin: level x 480 k
    rays), with the scene's tables, against its plain version."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import bvh, triangles
    from rray_tpu_torch.ops import jitter
    from rray_tpu_torch.render import integrator

    scene, (ro, rd) = camera_scene(path, torch)
    use_bvh = scene.counts[6] >= RenderSettings().bvh_min_tris
    module, attr = ((bvh, "bvh_closest_triangle") if use_bvh
                    else (triangles, "any_triangle"))
    calls = []
    kernel = getattr(module, attr)

    def spy(*a, **k):
        if k.get("any_hit") or not use_bvh:
            calls.append((a, k))
        return kernel(*a, **k)

    setattr(module, attr, spy)
    try:
        integrator._fast_node_eval(
            scene, ro, rd, RenderSettings(),
            jitter.seed_table(0, 0, len(scene.lights))[0].tolist())
    finally:
        setattr(module, attr, kernel)
    if not calls:
        fail(f"{name}: the fast node made no {attr} any-hit call")
    a, k = calls[0]
    fn = functools.partial(kernel, *a, **k)
    plain = (bvh.bvh_closest_triangle_reference if use_bvh
             else triangles.any_triangle_reference)
    plain_fn = functools.partial(
        plain, *a, chunk=64,
        **{key: v for key, v in k.items() if key != "tables"})
    if use_bvh:
        dist = k["dist"]
        kf, pf = (fn()[0] < dist).int(), (plain_fn()[0] < dist).int()
    else:
        dist = a[3]
        kf, pf = fn(), plain_fn()
    torch.cuda.synchronize()
    R = dist.shape[0]
    err = compare_flags(torch, kf, pf, f"{attr} {name} shadow call ({R} rays)")
    geom, T = a[2], a[2][0].shape[0]
    occluded = pf != 0
    tests = triangle_tests(torch, (a[0], a[1]), geom,
                           torch.where(occluded, -math.inf, dist)) \
        + int(occluded.sum())
    results.setdefault(attr, []).append(dict(
        what=f"{name} shadow call ({R} rays)", fn=fn, plain_fn=plain_fn,
        max_abs=err,
        bound=bound_ms(4 * (7 * R + 9 * T) + 4 * R, tests * OPS_TRI)))


def triangle_phase(torch, name, path, results, yardstick=False):
    """The fast node's triangle kernel (B2 or B4) against its plain
    version on the camera rays, closest hit seeded with the analytic
    hit, with normals and payload as the fast node asks and the scene's
    tables; then shadow any-hit (B3 or B4) from the hit points toward
    the light. With `yardstick`, B2's and B3's calls are also made on
    the BVH kernel with a tree of the same triangles (card_tables), for
    its time beside theirs; the scene does not route there."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import bvh, triangles
    from rray_tpu_torch.ops import soa

    settings = RenderSettings()
    scene, (ro, rd) = camera_scene(path, torch)
    rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
    T = scene.counts[6]
    use_bvh = T >= settings.bvh_min_tris
    t_an = soa.analytic_closest(scene, ro, rd)[0]
    tri = soa._tri_comps(scene, normals=True)
    aux = soa._tri_aux(scene)
    if use_bvh:
        tables = soa._bvh_tables(scene)
        closest = functools.partial(bvh.bvh_closest_triangle, *rays, tri,
                                    dist=t_an, aux=aux, tables=tables)
        closest_plain = functools.partial(
            bvh.bvh_closest_triangle_reference, *rays, tri, dist=t_an,
            aux=aux, chunk=128)
    else:
        tables = soa._tri_tables(scene)
        closest = functools.partial(triangles.closest_triangle, *rays, tri,
                                    t_init=t_an, aux=aux, tables=tables)
        closest_plain = functools.partial(
            triangles.closest_triangle_reference, *rays, tri, t_init=t_an,
            aux=aux, chunk=128)
    kern = closest()
    plain = closest_plain()
    torch.cuda.synchronize()
    kname = "bvh_closest_triangle" if use_bvh else "closest_triangle"
    err = compare_hits(torch, kern, plain, len(aux), f"{kname} {name} closest")
    if yardstick:
        card_tables = bvh.card_tables(tri, aux)
        yard = functools.partial(bvh.bvh_closest_triangle, *rays, tri,
                                 dist=t_an, aux=aux, tables=card_tables)
        compare_hits(torch, yard(), plain, len(aux),
                     f"yardstick bvh_closest_triangle {name} closest")
        results.setdefault("yardstick", []).append(dict(
            what=f"{name} closest", fn=yard))
    R = ro.x.shape[0]
    t_hit = torch.minimum(t_an, plain[0])
    tests = triangle_tests(torch, rays, tri, t_hit)
    # Read: rays 6 + bound 1 per ray, 18 + 2 aux per triangle; written:
    # t, u, v, idx, normal 3, aux 2 per ray.
    n_bytes = 4 * (7 * R + 20 * T) + 4 * 9 * R
    results.setdefault(kname, []).append(dict(
        what=f"{name} closest", fn=closest, plain_fn=closest_plain,
        max_abs=err, bound=bound_ms(n_bytes, tests * OPS_TRI)))

    # Shadow rays from just in front of each hit toward the light.
    light = scene.lights[0].position
    found = torch.isfinite(t_hit)
    t_back = torch.where(found, t_hit - 1e-3, 0.0)
    over = [o + d * t_back for o, d in zip(rays[0], rays[1])]
    to = [light[j] - over[j] for j in range(3)]
    dist = torch.sqrt(to[0] * to[0] + to[1] * to[1] + to[2] * to[2])
    srays = (tuple(over), tuple(c / dist for c in to))
    geom = tri[:9]
    if use_bvh:
        any_k = functools.partial(bvh.bvh_closest_triangle, *srays, geom,
                                  dist=dist, any_hit=True, tables=tables)
        any_p = functools.partial(bvh.bvh_closest_triangle_reference,
                                  *srays, geom, dist=dist, any_hit=True,
                                  chunk=128)
        flags = lambda out: (out[0] < dist).int()
        aname = "bvh_closest_triangle"
    else:
        any_k = functools.partial(triangles.any_triangle, *srays, geom, dist,
                                  tables=tables)
        any_p = functools.partial(triangles.any_triangle_reference, *srays,
                                  geom, dist, chunk=128)
        flags = lambda out: out
        aname = "any_triangle"
    kf, pf = flags(any_k()), flags(any_p())
    torch.cuda.synchronize()
    err = compare_flags(torch, kf, pf, f"{aname} {name} shadow")
    if yardstick:
        yard = functools.partial(bvh.bvh_closest_triangle, *srays, geom,
                                 dist=dist, any_hit=True, tables=card_tables)
        compare_flags(torch, (yard()[0] < dist).int(), pf,
                      f"yardstick bvh_closest_triangle {name} shadow")
        results.setdefault("yardstick", []).append(dict(
            what=f"{name} shadow", fn=yard))
    # An occluded ray needs one test (its hit), an open one every
    # triangle whose AABB it enters before the light.
    occluded = pf != 0
    tests = triangle_tests(torch, srays, geom,
                           torch.where(occluded, -math.inf, dist)) \
        + int(occluded.sum())
    n_bytes = 4 * (7 * R + 9 * T) + 4 * R
    results.setdefault(aname, []).append(dict(
        what=f"{name} shadow", fn=any_k, plain_fn=any_p, max_abs=err,
        bound=bound_ms(n_bytes, tests * OPS_TRI)))


# The main path's runs: (scene, aa, the kernels that scene's path must
# launch), and the launches a run must make at least where one is not
# enough (area9: one any-hit call per row of its level-5 samples).
RUNS = (("glass", 1, ("whitted_compact",)),
        ("example1", 1, ("whitted_compact",)),
        ("example1", 2, ("whitted_compact",)),
        ("mesh4", 1, ("whitted_compact",)),
        ("mesh4r", 1, ("whitted_compact",)),
        ("mesh9", 1, ("closest_triangle", "any_triangle")),
        ("mesh4b", 1, ("bvh_closest_triangle",)),
        ("area", 1, ("whitted_compact",)),
        ("area", 3, ("whitted_compact",)),
        ("area4", 1, ("whitted_compact",)),
        ("area21", 1, ("area_shadow_fraction",)),
        ("area4b", 1, ("bvh_closest_triangle",)),
        ("area9", 1, ("closest_triangle", "any_triangle")),
        ("csg5r", 1, ("whitted_compact",)),
        ("tex5r", 1, ()),
        ("csg", 5, ("whitted_compact",)),
        ("glass4", 1, ("closest_triangle", "any_triangle")),
        ("glass4b", 1, ("bvh_closest_triangle",)),
        ("glass21", 1, ("area_shadow_fraction",)),
        ("csgglass", 1, ()),
        ("csgmesh", 1, ()))
MIN_LAUNCHES = {("area9", "any_triangle"): 5}


def launch_counts(reset=False):
    """Every kernel wrapper's launch count (set to 0 first if `reset`)."""
    from rray_tpu_torch.kernels import (analytic, bvh, deflate, downsample,
                                        triangles, whitted)

    if reset:
        whitted.launches = analytic.launches = bvh.launches = 0
        triangles.closest_launches = triangles.any_launches = 0
        downsample.launches = deflate.launches = 0
    return {"whitted_compact": whitted.launches,
            "closest_triangle": triangles.closest_launches,
            "any_triangle": triangles.any_launches,
            "bvh_closest_triangle": bvh.launches,
            "area_shadow_fraction": analytic.launches,
            "downsample": downsample.launches,
            "deflate_match": deflate.launches}


def main_path(torch, np, scene_paths):
    """The main path as the CLI drives it, each scene's run with the
    launch counts set to 0 just before it and read just after -> images
    and the launch counts summed over the runs."""
    from PIL import Image

    from rray_tpu_torch import api

    from rray_tpu_torch.kernels import bvh, triangles

    images, total = {}, launch_counts(reset=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, aa, expect in RUNS:
            w, h = size_of(name)
            png = os.path.join(tmp, f"{name}_aa{aa}.png")
            builds = bvh.tree_builds
            tri_builds = triangles.table_builds
            launch_counts(reset=True)
            t0 = time.perf_counter()
            image = api.render_scene_from_file(scene_paths[name], w, h, png,
                                               aa=aa, device=DEVICE)
            wall = time.perf_counter() - t0
            counts = launch_counts()
            builds = bvh.tree_builds - builds
            tri_builds = triangles.table_builds - tri_builds
            shape = np.asarray(Image.open(png)).shape
            if shape != (h, w, 4):
                fail(f"{png}: PNG shape {shape}")
            if not np.isfinite(image).all() or image.max() <= 0.1:
                fail(f"{name} aa={aa}: non-finite or black image")
            images[(name, aa)] = image
            print(f"main path {name} {w}x{h} aa={aa}: PNG {shape}, "
                  f"{wall * 1e3:.1f} ms wall, PNG write included, launches "
                  f"{json.dumps({k: n for k, n in counts.items() if n})}, "
                  f"BVH trees built {builds}, triangle tables built "
                  f"{tri_builds} [{card_state()}]")
            if builds != (1 if counts["bvh_closest_triangle"] else 0):
                fail(f"{name} aa={aa}: {builds} BVH trees built for "
                     f"{counts['bvh_closest_triangle']} BVH launches (one "
                     f"per scene)")
            tri_launches = counts["closest_triangle"] + counts["any_triangle"]
            if tri_builds != (1 if tri_launches else 0):
                fail(f"{name} aa={aa}: {tri_builds} triangle tables built "
                     f"for {tri_launches} triangle-kernel launches (one per "
                     f"scene)")
            for kname in expect:
                if counts[kname] < MIN_LAUNCHES.get((name, kname), 1):
                    fail(f"the main path on {name} aa={aa} launched {kname} "
                         f"{counts[kname]} times")
            # The box filter runs on the card once a frame at aa > 1, and
            # not at all at aa = 1.
            if counts["downsample"] != (1 if aa > 1 else 0):
                fail(f"the main path on {name} aa={aa} launched downsample "
                     f"{counts['downsample']} times")
            # Each frame's PNG has its match search on the card, once.
            if counts["deflate_match"] != 1:
                fail(f"the main path on {name} aa={aa} launched the deflate "
                     f"match search {counts['deflate_match']} times")
            total = {k: total[k] + counts[k] for k in total}
    print(f"main path kernel launches: {json.dumps(total)}")
    return images, total


def downsample_phase(torch, np, size=(1920, 1080), aa=5, reps=3):
    """The box-filter downsample kernel (kernels/downsample.py) at config
    5's main-path size: one launch on a seeded [h*aa, w*aa, 3] raster on
    the card, bit for bit against canvas.downsample of its host copy and
    against the plain version on the card; then, in turns, its device
    time beside its byte bound, the plain version's time, and
    torch.mean(dim=(1, 3)) as a yardstick (not the same bits, never on
    the port's path); and, on the host clock, the frame's output steps
    before and after it: the raster's copy and numpy's mean, against the
    image's copy."""
    from rray_tpu_torch.kernels import downsample
    from rray_tpu_torch.render import canvas

    w, h = size
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    raster = torch.rand((h * aa, w * aa, 3), generator=gen, device=DEVICE)
    before = downsample.launches
    image = downsample.downsample(raster, aa)
    if downsample.launches != before + 1:
        fail(f"downsample made {downsample.launches - before} launches")
    torch.cuda.synchronize()

    def host_ms(fn):
        out, times = None, []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, sorted(times)[len(times) // 2]

    host, raster_copy_ms = host_ms(lambda: raster.cpu().numpy())
    want, mean_host_ms = host_ms(lambda: canvas.downsample(host, aa))
    got, image_copy_ms = host_ms(lambda: image.cpu().numpy())
    if not np.array_equal(got, want, equal_nan=True):
        fail(f"downsample {w}x{h} aa={aa}: the kernel differs from "
             f"canvas.downsample at {int((got != want).sum())} values")
    if not torch.equal(downsample.downsample_reference(raster, aa), image):
        fail(f"downsample {w}x{h} aa={aa}: the kernel differs from its "
             "plain version on the card")
    print(f"parity downsample {w}x{h} aa={aa}: kernel, plain version on the "
          f"card and canvas.downsample of the host copy bit for bit "
          f"({got.size} values)")
    ms, call, plain_ms = timed_turns(
        torch, f"downsample {w}x{h} aa={aa}", "downsample_kernel",
        lambda: downsample.downsample(raster, aa),
        lambda: downsample.downsample_reference(raster, aa))
    view = raster.view(h, aa, w, aa, 3)
    mean_ms, _ = window_ms(torch, lambda: view.mean(dim=(1, 3)))
    bound = bound_ms(4 * (raster.numel() + image.numel()),
                     raster.numel() + image.numel())
    print(f"time downsample {w}x{h} aa={aa}: kernel {ms:.5f} ms on the "
          f"device ({100 * bound[0] / ms:.1f}% of its bound), call "
          f"{call:.5f} ms, plain {plain_ms:.5f} ms, torch.mean(dim=(1, 3)) "
          f"{mean_ms:.5f} ms (not bit-exact), bound {bound[0]:.5f} ms "
          f"({bound[1]}; {bound[2]}); host clock, medians of {reps}: raster "
          f"copy {raster_copy_ms:.1f} ms + numpy mean {mean_host_ms:.1f} ms "
          f"before, image copy {image_copy_ms:.2f} ms after "
          f"[{card_state()}]")
    return {"ms": ms, "call_ms": call, "plain_ms": plain_ms,
            "mean_ms": mean_ms, "bound": bound,
            "max_abs": float(np.abs(got - want).max())}


def png_phase(torch, np, scene_paths, reps=5):
    """The PNG of a card image (kernels/deflate.py, io/deflate.py) at both
    cells' sizes, config 5 at 1920x1080 aa=5 and glass at 800x600: one
    match search on the main path's image, its tables equal to the plain
    version's on the card (raw stream, table, listed rows by the
    directory) and its PNG bytes equal to canvas.write_png's
    (compress2); then, in turns, the match kernel's device time beside
    its bound (the bytes it must read and write; the 4-byte words its
    walks must compare, one integer operation each: a scan_end word per
    candidate once a match is held, and the whole comparisons of the
    candidates that pass it), the call (quantize, chain links in torch
    ops, match search), the plain version; and on the host clock,
    medians of `reps`, the emitter against compress2 on the same stream
    and the whole PNG against canvas.write_png's."""
    from rray_tpu_torch import api
    from rray_tpu_torch.io import deflate as emitter
    from rray_tpu_torch.io import native
    from rray_tpu_torch.kernels import deflate
    from rray_tpu_torch.render import canvas

    print(f"png: the emitter links zlib {emitter.zlib_version()}")

    def host_ms(fn):
        out, times = None, []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, sorted(times)[len(times) // 2]

    rows_out = {}
    for name, (w, h, aa) in (("csg", (1920, 1080, 5)),
                             ("glass", (WIDTH, HEIGHT, 1))):
        spec, lights, shapes = api.load_scene_file(scene_paths[name])
        image, to_host = api._render_image(spec, lights, shapes, w, h, aa,
                                           None, 0, None, DEVICE)
        host = to_host()
        n = deflate.raw_size(h, w)
        before = deflate.launches
        raw, table, rows, directory, count = deflate.match_tables(image)
        if deflate.launches != before + 1:
            fail(f"png {name}: {deflate.launches - before} match launches")
        rows = rows[:int(count[0])]
        ordered = torch.cat([rows[a:a + c] for a, c in directory.tolist()])
        want_raw = deflate.quantize_reference(image)
        want_table, want_rows, _ = deflate.match_tables_reference(want_raw)
        work = dict(deflate.last_work)
        pairs = ((raw, want_raw), (table, want_table), (ordered, want_rows))
        if any(a.shape != b.shape for a, b in pairs):
            fail(f"png {name} {w}x{h}: the kernels' tables have other "
                 "shapes than the plain version's")
        # The largest difference of any raw byte, table word or row entry.
        max_diff = max(int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0
                       for a, b in pairs)
        if max_diff:
            fail(f"png {name} {w}x{h}: the kernels' tables differ from the "
                 f"plain version's by up to {max_diff}")
        rgba = native.quantize_native(np.nan_to_num(
            np.asarray(host, np.float32)))
        want, zlib_ms = host_ms(lambda: native.encode_png_native(rgba))
        tables = [raw.cpu().numpy(), table.cpu().numpy(),
                  ordered.cpu().numpy(),
                  deflate.directory_of(ordered[:, 0], n).cpu().numpy()]
        got, emit_ms = host_ms(lambda: emitter.encode(*tables, w, h))
        frame_png, png_ms = host_ms(lambda: emitter.png_bytes(image))
        path = os.path.join(tempfile.gettempdir(), "rray_png_phase.png")
        _, write_png_ms = host_ms(lambda: canvas.write_png(path, host))
        with open(path, "rb") as f:
            if not (got == want == frame_png == f.read()):
                fail(f"png {name} {w}x{h}: the PNG differs from compress2's")
        print(f"parity png {name} {w}x{h} aa={aa}: raw stream ({n} bytes), "
              f"table, {rows.shape[0]} listed rows and the PNG "
              f"({len(want)} bytes) equal the plain version's and "
              f"compress2's")
        ms, call, plain_ms = timed_turns(
            torch, f"deflate_match {name} {w}x{h}", "deflate_match_kernel",
            lambda: deflate.match_tables(image),
            lambda: deflate.match_tables_reference(
                deflate.quantize_reference(image)))
        bound = bound_ms(7 * n, 0, work["words"])
        print(f"time deflate_match {name} {w}x{h}: kernel {ms:.5f} ms on the "
              f"device ({100 * bound[0] / ms:.1f}% of its bound), call "
              f"(quantize, chain links, search) {call:.5f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}; "
              f"{bound[2]}; {work['candidates']} candidates, "
              f"{work['compared']} compared whole, {work['words']} words "
              f"compared); host clock, medians of "
              f"{reps}: emitter {emit_ms:.2f} ms against compress2 "
              f"{zlib_ms:.2f} ms on the same stream, the whole PNG "
              f"{png_ms:.2f} ms against canvas.write_png {write_png_ms:.2f} "
              f"ms [{card_state()}]")
        rows_out[name] = {"ms": ms, "call_ms": call, "plain_ms": plain_ms,
                          "bound": bound, "emit_ms": emit_ms,
                          "zlib_ms": zlib_ms, "max_abs": max_diff}
    return rows_out


def whitted_plain_image(torch, np, path, aa):
    """The main path's image of a whitted-kernel scene with the kernel's
    plain version in its place (camera rays, downsampled by aa)."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import whitted
    from rray_tpu_torch.render import canvas

    scene, (ro, rd) = camera_scene(path, torch, aa)
    rgb = whitted.whitted_compact_reference(
        (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z),
        **whitted.kernel_inputs(scene, RenderSettings()))
    image = torch.stack(rgb, -1).reshape(HEIGHT * aa, WIDTH * aa, 3)
    return canvas.downsample(image.cpu().numpy(), aa)


# The oracle phase: integrator.render_aos (rray_tpu's per-ray
# _color_at_sorted: ops/hits.py, ops/normals.py, render/patterns.py,
# none of the kernels) against the routed frame of the same scene
# (api.render_scene_from_file at wavefront_capacity 2^depth, where no
# path is dropped) on the card in float32, point lights only (the AoS
# key chain is not the routed one), by (scene, route). The budget is
# rray_tpu's for two f32 formulations of one scene
# (tests/test_wavefront.py): under ORACLE_SHARE of the pixels with a
# channel |diff| over ORACLE_PIX, and a median channel |diff| under
# ORACLE_MEDIAN.
ORACLE = (("example1", "kernel"), ("glass", "kernel"), ("mesh4", "kernel"),
          ("csg", "kernel"), ("mesh9", "fast"), ("mesh4b", "fast"),
          ("glass4", "sorted"), ("csgglass", "sorted"))
ORACLE_PIX, ORACLE_SHARE, ORACLE_MEDIAN = 1e-3, 5e-3, 1e-6
# The unrolled phase: render_scene_from_file under wavefront "unrolled"
# against "scan" at 800x600 (the same per-level seeds, area lights
# included; only the order of each pixel's sum differs), within
# UNROLLED_TOL (rray_tpu's scan-versus-reordered bound,
# tests/test_wavefront.py), and the kernels each unrolled run must
# launch; whitted_compact must not (rray_tpu's dispatcher takes
# "unrolled" past its kernel). glass4b renders at UNROLLED_HALF: its
# transparent 3120-triangle mesh's n1/n2 fold is torch code over every
# row of the exhaustive wavefronts (2^l rows per pixel at level l, 32
# at every level for "scan"), and the pair took 70.6 s of the phase's
# 90.4 s at 800x600 on an H100 at 700 W.
UNROLLED = (("glass", ()), ("glass4", ("closest_triangle", "any_triangle")),
            ("glass4b", ("bvh_closest_triangle",)),
            ("glass21", ("area_shadow_fraction",)), ("csgglass", ()))
UNROLLED_HALF = {"glass4b": (WIDTH // 2, HEIGHT // 2)}
UNROLLED_TOL = 2e-6


def oracle_phase(torch, np, scene_paths, card):
    """Each ORACLE scene's AoS frame (rows batched by integrator.render_aos,
    launch counts from 0 around it: it must launch none) against its
    routed frame (launches counted from 0 around it) -> the routed
    frames' launch counts summed."""
    from rray_tpu_torch import api
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.render import integrator

    t_phase = time.perf_counter()
    total = launch_counts(reset=True)
    for name, want in ORACLE:
        w, h = size_of(name)
        scene, cam = camera_data(scene_paths[name], torch, (w, h))
        settings = RenderSettings()
        settings = dataclasses.replace(
            settings, wavefront_capacity=2 ** settings.depth)
        if integrator.route(scene, settings) != want:
            fail(f"oracle {name}: route {integrator.route(scene, settings)}, "
                 f"not {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        aos = integrator.render_aos(scene, cam, settings)
        torch.cuda.synchronize()
        aos_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        if any(launch_counts().values()):
            fail(f"oracle {name}: the AoS frame launched kernels "
                 f"{launch_counts()}")
        t0 = time.perf_counter()
        routed = api.render_scene_from_file(scene_paths[name], w, h, "",
                                            settings=settings, device=DEVICE)
        routed_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        total = {k: total[k] + counts[k] for k in total}
        aos = aos.cpu().numpy()
        if not np.isfinite(aos).all() or aos.max() <= 0.1:
            fail(f"oracle {name}: non-finite or black AoS frame")
        diff = np.abs(aos - routed)
        share = float((diff.max(axis=2) > ORACLE_PIX).mean())
        median = float(np.median(diff))
        print(f"oracle {name} {w}x{h} route {want}: AoS {aos_ms:.1f} ms "
              f"wall, routed {routed_ms:.1f} ms wall (launches "
              f"{json.dumps({k: n for k, n in counts.items() if n})}), "
              f"share over {ORACLE_PIX} {share:.3e}, median |diff| "
              f"{median:.3e}, max |diff| {float(diff.max()):.3e}, AoS peak "
              f"memory {peak:.1f} MiB [{card}]")
        if not (share < ORACLE_SHARE and median < ORACLE_MEDIAN):
            fail(f"oracle {name}: share {share:.3e} (limit {ORACLE_SHARE}), "
                 f"median {median:.3e} (limit {ORACLE_MEDIAN})")
    print(f"oracle phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"[{card}]")
    # The sharded phase's ranks share this card: hand back the blocks
    # the AoS frames left in the caching allocator.
    torch.cuda.empty_cache()
    return total


def unrolled_phase(torch, np, scene_paths, card):
    """Each UNROLLED scene through render_scene_from_file under
    "unrolled" (launch counts from 0 around it) against "scan" -> the
    unrolled runs' launch counts summed."""
    from rray_tpu_torch import api
    from rray_tpu_torch.config import RenderSettings

    t_phase = time.perf_counter()
    total = launch_counts(reset=True)
    for name, expect in UNROLLED:
        w, h = UNROLLED_HALF.get(name, (WIDTH, HEIGHT))
        frames, ms, peak = {}, {}, {}
        for wavefront in ("unrolled", "scan"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launch_counts(reset=True)
            t0 = time.perf_counter()
            frames[wavefront] = api.render_scene_from_file(
                scene_paths[name], w, h, "",
                settings=RenderSettings(wavefront=wavefront), device=DEVICE)
            ms[wavefront] = (time.perf_counter() - t0) * 1e3
            peak[wavefront] = torch.cuda.max_memory_allocated() / 2 ** 20
            if wavefront == "unrolled":
                counts = launch_counts()
        total = {k: total[k] + counts[k] for k in total}
        image = frames["unrolled"]
        if not np.isfinite(image).all() or image.max() <= 0.1:
            fail(f"unrolled {name}: non-finite or black image")
        diff = float(np.abs(image - frames["scan"]).max())
        half = (" (half size: the exhaustive wavefronts' mesh fold)"
                if (w, h) != (WIDTH, HEIGHT) else "")
        print(f"unrolled {name} {w}x{h}{half}: {ms['unrolled']:.1f} ms wall "
              f"(scan {ms['scan']:.1f} ms), peak memory "
              f"{peak['unrolled']:.1f} MiB (scan {peak['scan']:.1f} MiB), "
              f"max |unrolled - scan| {diff:.3e}, launches "
              f"{json.dumps({k: n for k, n in counts.items() if n})} "
              f"[{card}]")
        if diff > UNROLLED_TOL:
            fail(f"unrolled {name}: max |unrolled - scan| {diff:.3e} > "
                 f"{UNROLLED_TOL}")
        if counts["whitted_compact"]:
            fail(f"unrolled {name}: whitted_compact launched "
                 f"{counts['whitted_compact']} times")
        for kname in expect:
            if not counts[kname]:
                fail(f"unrolled {name}: {kname} did not launch")
    print(f"unrolled phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"[{card}]")
    torch.cuda.empty_cache()  # as after the oracle phase
    return total


def frame_breakdown(torch, np, name, path, aa=1, reps=5):
    """Where a CLI-path frame's wall time goes at the scene's size, aa
    (host clock, each phase ended by a synchronize; medians of `reps`
    calls after a warm-up), and the device's busy share of one frame
    (torch.profiler)."""
    from rray_tpu_torch import api
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.kernels import downsample, whitted
    from rray_tpu_torch.ops import jitter
    from rray_tpu_torch.render import canvas, integrator
    from rray_tpu_torch.render.camera import (Camera, all_rays_soa,
                                              compile_camera)
    from rray_tpu_torch.scene.data import compile_scene

    settings = RenderSettings()
    w, h = size_of(name)
    phases = {}

    def mark(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        phases.setdefault(key, []).append((t1 - t0) * 1e3)
        return t1

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        for rep in range(reps + 1):
            torch.cuda.synchronize()
            t0 = start = time.perf_counter()
            cam_spec, lights, shapes = load_scene_file(path)
            t0 = mark("load_scene_file (YAML, OBJ)", t0)
            scene = compile_scene(shapes, lights, device=DEVICE)
            t0 = mark("compile_scene", t0)
            cam = Camera(w * aa, h * aa, cam_spec["fov"])
            cam.transform = cam_spec["transform"]
            ro, rd = all_rays_soa(compile_camera(cam, torch.float32, DEVICE))
            t0 = mark("camera rays", t0)
            node = integrator.route(scene)
            if node == "kernel":
                inputs = whitted.kernel_inputs(scene, settings)
                t0 = mark("table packing", t0)
                rgb = whitted.whitted_compact((ro.x, ro.y, ro.z),
                                              (rd.x, rd.y, rd.z), **inputs,
                                              width=w * aa)
                t0 = mark("whitted kernel call", t0)
            elif node == "sorted":
                out = integrator.sorted_frame(
                    scene, ro, rd, w * aa, settings,
                    jitter.seed_table(0, settings.depth, len(scene.lights)))
                rgb = (out.x, out.y, out.z)
                t0 = mark("sorted node (torch ops + triangle, BVH and area "
                          "kernels)", t0)
            else:
                out = integrator.color_at_fast(
                    scene, ro, rd, settings.depth, settings,
                    jitter.seed_table(0, settings.depth, len(scene.lights)))
                rgb = (out.x, out.y, out.z)
                t0 = mark("fast node (triangle kernels + torch ops)", t0)
            image = torch.stack(rgb, -1).reshape(h * aa, w * aa, 3)
            if aa > 1:  # as api.render_scene: on the card, before the copy
                image = downsample.downsample(image, aa)
                t0 = mark("AA downsample (card)", t0)
            image = image.cpu().numpy()
            t0 = mark("image to host", t0)
            canvas.write_png(png, image)
            t0 = mark("write_png", t0)
            mark("frame, by phases", start)
            t0 = time.perf_counter()
            api.render_scene_from_file(path, w, h, png, aa=aa,
                                       device=DEVICE)
            mark("render_scene_from_file", t0)
            if rep == 0:  # warm-up
                phases.clear()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            api.render_scene_from_file(path, w, h, png, aa=aa,
                                       device=DEVICE)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # Device-side events only: a torch op's row also carries the time of
    # the kernels it launched, which would count them twice.
    device = [(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3, e.key)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for ms, _ in device)
    for key, vals in phases.items():
        print(f"where the time goes {name} {w}x{h} aa={aa}: {key} "
              f"{float(np.median(vals)):.3f} ms (median of {len(vals)})")
    top = ", ".join(f"{key} {ms:.3f} ms" for ms, key in
                    sorted(device, reverse=True)[:5] if ms > 0)
    print(f"where the time goes {name} aa={aa}: device busy {busy:.3f} ms of a "
          f"{wall:.1f} ms profiled frame ({100 * busy / wall:.1f}%, "
          f"{len(device)} kernel names); top device time: {top} "
          f"[{card_state()}]")


def corrupted(torch, scene):
    """The scene with its last solid pattern's colour set to (0.2, 0.7,
    0.7) and its first light at half intensity (rray_tpu's
    test_training_reduces_loss corruption)."""
    from rray_tpu_torch.scene import data as sd

    last = max(i for i, p in enumerate(scene.patterns) if p.ptype == "solid")
    leaves = dict(sd.float_leaves(scene))
    return sd.replace_leaves(scene, {
        f".patterns[{last}].color": torch.tensor(
            [0.2, 0.7, 0.7], dtype=torch.float32, device=DEVICE),
        ".lights[0].intensity": leaves[".lights[0].intensity"] * 0.5})


def trainable(key):
    return ".color" in key or ".intensity" in key


def train_phase(torch, scene_paths):
    """Inverse rendering on the card through the port's entry point,
    parallel.train.make_train_step with torch.optim.Adam: TRAIN_STEPS
    steps on each TRAIN_SCENES scene at 800x600 against the true scene's
    render, every gradient finite, the last loss below the first. Per
    step: the forward (render_loss) and backward (loss.backward and the
    optimizer step) ms on the host clock around synchronizes, their
    ratio, and torch.cuda.max_memory_allocated over the step beside what
    was allocated when it began. The launch counts are set to 0 before
    the phase and read after it."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.parallel import train
    from rray_tpu_torch.render import integrator

    render_loss = train.render_loss
    fwd = []

    def timed_loss(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = render_loss(*args, **kwargs)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
        return loss

    settings = RenderSettings()
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    launch_counts(reset=True)
    train.render_loss = timed_loss
    try:
        for name in TRAIN_SCENES:
            scene, cam = camera_data(scene_paths[name], torch)
            with torch.no_grad():
                target = integrator.render(scene, cam, settings)
            state, rest = train.init_train_state(corrupted(torch, scene),
                                                 adam, trainable)
            step = train.make_train_step(rest, cam, settings, adam)
            losses = []
            for i in range(TRAIN_STEPS):
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated() / 2 ** 20
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, target)
                torch.cuda.synchronize()
                total = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                losses.append(float(loss))
                grads = [p.grad for p in state.params.values()
                         if p.grad is not None]  # None: a leaf unused
                if not all(bool(torch.isfinite(g).all()) for g in grads):
                    fail(f"train {name} step {i}: a gradient is not finite")
                if not any(bool((g != 0).any()) for g in grads):
                    fail(f"train {name} step {i}: every gradient is zero")
                f, b = fwd[-1], total - fwd[-1]
                print(f"train {name} {WIDTH}x{HEIGHT} step {i} "
                      f"(route {integrator.route(scene)}): loss "
                      f"{losses[-1]:.6e}, forward {f:.1f} ms, backward "
                      f"{b:.1f} ms, bwd/fwd {b / f:.2f}, peak memory "
                      f"{peak:.1f} MiB ({base:.1f} MiB allocated before "
                      f"the step) [{card_state()}]")
            if not losses[-1] < losses[0]:
                fail(f"train {name}: loss {losses} did not fall")
    finally:
        train.render_loss = render_loss
    counts = launch_counts()
    print(f"train phase kernel launches: {json.dumps(counts)}")
    for kname in TRAIN_KERNELS:
        if counts[kname] < 1:
            fail(f"the train phase launched {kname} {counts[kname]} times")


def leaf_grads(torch, loss, params):
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(params.items(), got)}


def grad_parity_phase(torch, scene_paths):
    """Gradient parity on the card at GRAD_SIZE, float32: render()'s
    kernel route against reference_node over every ray (both with the
    same leaves requiring grad, loss mean(image^2)), and the closest
    triangle Function fed by the triangle and BVH kernels against it fed
    by their plain versions (plain_kernels), each max relative
    difference printed and held to its bound."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.ops import jitter, soa
    from rray_tpu_torch.ops.vec import V3
    from rray_tpu_torch.parallel import train
    from rray_tpu_torch.render import integrator
    from rray_tpu_torch.render.camera import all_rays_soa
    from rray_tpu_torch.scene import data as sd

    settings = RenderSettings()
    for name in ("example1", "glass", "mesh4", "area"):
        scene, cam = camera_data(scene_paths[name], torch, GRAD_SIZE)
        if integrator.route(scene) != "kernel":
            fail(f"grad parity {name}: route {integrator.route(scene)}")
        params, rest = train.partition_scene(scene)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        image = integrator.render(train.merge_scene(params, rest), cam,
                                  settings)
        kern = leaf_grads(torch, torch.mean(image ** 2), params)
        ro, rd = all_rays_soa(cam)
        out = integrator.reference_node(
            sd.canonicalize(train.merge_scene(params, rest)), ro, rd,
            settings.depth, settings,
            jitter.seed_table(0, settings.depth, len(scene.lights)))
        ref = torch.stack((out.x, out.y, out.z), -1)
        torch_route = leaf_grads(torch, torch.mean(ref ** 2), params)
        worst, bad = 0.0, []
        for key, g in torch_route.items():
            if not g.numel():
                continue
            scale = float(g.abs().max())
            diff = float((kern[key] - g).abs().max())
            if scale > 0:
                worst = max(worst, diff / scale)
            if not (bool(torch.isfinite(kern[key]).all()) and bool(
                    ((kern[key] - g).abs()
                     <= GRAD_RTOL * g.abs() + GRAD_ATOL).all())):
                bad.append(key)
        print(f"grad parity {name} {GRAD_SIZE[0]}x{GRAD_SIZE[1]}: kernel "
              f"route vs torch route, max |diff| / max |g| over leaves "
              f"{worst:.3e} (bound: rtol {GRAD_RTOL}, atol {GRAD_ATOL})")
        if bad:
            fail(f"grad parity {name}: leaves {bad} outside rtol "
                 f"{GRAD_RTOL}, atol {GRAD_ATOL}")

    names = ("tri_p1", "tri_e1", "tri_e2", "tri_n1", "tri_n2", "tri_n3")
    for name in ("mesh4", "mesh4b"):
        scene, cam = camera_data(scene_paths[name], torch, GRAD_SIZE)
        T = scene.counts[6]
        ro, rd = all_rays_soa(cam)
        w = torch.rand((4, ro.x.shape[0]), device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(0))

        def run():
            tabs = {n: getattr(scene, n).clone().requires_grad_()
                    for n in names}
            rays = [c.clone().requires_grad_()
                    for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
            s = dataclasses.replace(scene, **tabs)
            t, _, _, n, _ = soa._triangle_best(
                s, V3(*rays[:3]), V3(*rays[3:]), settings,
                torch.full_like(rays[0], 1e30))
            found = torch.isfinite(t)
            loss = sum((torch.where(found, c, 0.0) * wk).sum()
                       for c, wk in zip((t, *n), w))
            return torch.autograd.grad(loss, list(tabs.values()) + rays)

        kern = run()
        with plain_kernels():
            plain = run()
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                    for a, b in zip(kern, plain))
        kname = ("bvh_closest_triangle" if T >= settings.bvh_min_tris
                 else "closest_triangle")
        print(f"grad parity closest Function {name} ({T} triangles, "
              f"{kname}) {GRAD_SIZE[0]}x{GRAD_SIZE[1]}: kernels vs plain "
              f"versions, max |diff| / max |g| over tables and rays "
              f"{worst:.3e} (bound {CLOSEST_TOL})")
        if not worst <= CLOSEST_TOL:
            fail(f"grad parity closest Function {name}: {worst:.3e}")

# ---------------------------------------------------------------------------
# Progressive, resilient and sharded rendering, profiling.
# ---------------------------------------------------------------------------

# Progressive frames: config 3 at aa=3 in bands of PROG_BAND_ROWS raster
# rows (1800 rows: 29 bands, 29 whitted launches), glass at aa=1 (a
# point light: equal to the one-shot frame bit for bit), and config 3 at
# aa=1 cut after PROG_CUT_BANDS bands and resumed from its checkpoint.
PROG_BAND_ROWS = 64
PROG_CUT_BANDS = 3
# render_resilient: example1 in bands of RESILIENT_BAND_ROWS rows (5
# bands), every child killed after two bands: three children.
RESILIENT_BAND_ROWS = 128
RESILIENT_FAIL_AFTER = 2
# render_sharded over two ranks on the one card (gloo: NCCL refuses two
# ranks on one GPU): the kernel route (glass, config 3), the fast node
# with the BVH kernel (mesh4b) and the sorted node (glass4); the kernels
# each rank must launch.
SHARDED_WORLD = 2
SHARDED_TIMEOUT_S = 300
SHARDED_RUNS = (("glass", ("whitted_compact",)),
                ("area", ("whitted_compact",)),
                ("mesh4b", ("bvh_closest_triangle",)),
                ("glass4", ("closest_triangle", "any_triangle")))
# The sharded train step (SHARD_TRAIN_STEPS Adam steps on example1)
# against the single-process step: float32 sums in another order, so
# the loss within SHARD_RTOL relative and each leaf's gradient within
# SHARD_RTOL of that leaf's largest gradient.
SHARD_RTOL = 1e-5
SHARD_TRAIN_STEPS = 2
# The local mesh: render_sharded over LOCAL_ENTRIES entries of one
# process, entry i on cuda:(i % device_count) (four blocks on one card
# here), each frame bit for bit the single-process frame and each
# LOCAL_RUNS kernel launched; one local-mesh Adam step on example1 within
# SHARD_RTOL of each leaf's largest single-process gradient.
LOCAL_ENTRIES = 4
LOCAL_RUNS = (("glass", ("whitted_compact",)),
              ("area", ("whitted_compact",)),
              ("mesh4b", ("bvh_closest_triangle",)),
              ("glass4", ("closest_triangle", "any_triangle")),
              ("area21", ("area_shadow_fraction",)))


@contextlib.contextmanager
def plain_whitted():
    """Route the whitted kernel's calls to its plain version on the card
    (which does not count as a launch)."""
    from rray_tpu_torch.kernels import whitted

    saved = whitted.whitted_compact

    def plain(*args, width=None, **kwargs):
        return whitted.whitted_compact_reference(*args, **kwargs)

    whitted.whitted_compact = plain
    try:
        yield
    finally:
        whitted.whitted_compact = saved


def timed(torch, fn, *args, **kwargs):
    """(fn(...), ms on the host clock between synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def progressive_phase(torch, np, scene_paths, images):
    """api.render_scene_progressive on the card: config 3 at aa=3 in 29
    bands (launches and table builds counted from 0 around it; held
    against the same bands through the whitted kernel's plain version
    at the main path's image thresholds; its frame time beside the
    one-shot frame's), glass against its main-path frame bit for bit,
    and a frame cut by RRAY_FAIL_AFTER_BANDS and resumed against the
    uninterrupted frame bit for bit -> the launch counts."""
    from rray_tpu_torch import api
    from rray_tpu_torch.kernels import whitted

    w, h, aa = WIDTH, HEIGHT, 3
    bands = -(-h * aa // PROG_BAND_ROWS)
    area = scene_paths["area"]
    _, one_ms = timed(torch, api.render_scene_from_file, area, w, h, "",
                      aa=aa, device=DEVICE)
    counts = launch_counts(reset=True)
    builds = whitted.table_builds
    image, ms = timed(torch, api.render_scene_progressive, area, w, h, "",
                      aa=aa, band_rows=PROG_BAND_ROWS, device=DEVICE)
    counts = launch_counts()
    builds = whitted.table_builds - builds
    print(f"progressive area {w}x{h} aa={aa}, {bands} bands of "
          f"{PROG_BAND_ROWS} rows: {ms:.1f} ms wall (one-shot "
          f"render_scene_from_file {one_ms:.1f} ms), launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}, whitted "
          f"tables built {builds} [{card_state()}]")
    if counts["whitted_compact"] != bands or builds != 1:
        fail(f"progressive area: {counts['whitted_compact']} whitted "
             f"launches for {bands} bands, {builds} table builds (one)")
    if counts["downsample"] or counts["deflate_match"]:
        fail(f"progressive area: {counts['downsample']} downsample and "
             f"{counts['deflate_match']} match-search launches (the band "
             f"canvas is downsampled and deflated on the host)")
    with plain_whitted():
        plain, plain_ms = timed(torch, api.render_scene_progressive, area,
                                w, h, "", aa=aa, band_rows=PROG_BAND_ROWS,
                                device=DEVICE)
    diff = compare_images(torch, torch.from_numpy(image).unbind(-1),
                          torch.from_numpy(plain).unbind(-1),
                          "progressive area aa=3")
    print(f"parity progressive area aa={aa}: max |kernel - plain| "
          f"{diff:.3e} over the same {bands} band keys (plain frame "
          f"{plain_ms:.1f} ms wall)")

    launch_counts(reset=True)
    glass = api.render_scene_progressive(scene_paths["glass"], w, h, "",
                                         band_rows=PROG_BAND_ROWS,
                                         device=DEVICE)
    if not np.array_equal(glass, images[("glass", 1)]):
        fail("progressive glass differs from the one-shot frame")
    print(f"progressive glass {w}x{h}: equal to the one-shot frame bit for "
          f"bit")
    total = launch_counts()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "frame.npz")
        os.environ["RRAY_FAIL_AFTER_BANDS"] = str(PROG_CUT_BANDS)
        try:
            api.render_scene_progressive(area, w, h, "",
                                         band_rows=PROG_BAND_ROWS,
                                         checkpoint_path=ckpt, device=DEVICE)
            fail("RRAY_FAIL_AFTER_BANDS did not cut the frame")
        except RuntimeError as e:
            print(f"progressive area {w}x{h} cut: {e}")
        finally:
            del os.environ["RRAY_FAIL_AFTER_BANDS"]
        with np.load(ckpt) as state:
            done = int(state["done"].sum())
        resumed = api.render_scene_progressive(area, w, h, "",
                                               band_rows=PROG_BAND_ROWS,
                                               checkpoint_path=ckpt,
                                               device=DEVICE)
    whole = api.render_scene_progressive(area, w, h, "",
                                         band_rows=PROG_BAND_ROWS,
                                         device=DEVICE)
    if done != PROG_CUT_BANDS or not np.array_equal(resumed, whole):
        fail(f"progressive area resumed after {done} bands differs from "
             f"the uninterrupted frame")
    print(f"progressive area {w}x{h}: resumed after {done} bands, equal to "
          f"the uninterrupted frame bit for bit")
    return {k: counts[k] + total[k] for k in counts}


def resilient_phase(np, scene_paths):
    """api.render_resilient on example1 at 800x600 with every child CLI
    (--device cuda) killed after RESILIENT_FAIL_AFTER bands: rc 0, at
    least three children, and its PNG's bytes equal to the in-process
    progressive render's; the wall ms of every child."""
    from rray_tpu_torch import api

    path = scene_paths["example1"]
    bands = -(-HEIGHT // RESILIENT_BAND_ROWS)
    children = []
    call = subprocess.call

    def timed_call(*args, **kwargs):
        t0 = time.perf_counter()
        rc = call(*args, **kwargs)
        children.append(((time.perf_counter() - t0) * 1e3, rc))
        return rc

    with tempfile.TemporaryDirectory() as tmp:
        want_png = os.path.join(tmp, "progressive.png")
        png = os.path.join(tmp, "resilient.png")
        api.render_scene_progressive(path, WIDTH, HEIGHT, want_png,
                                     band_rows=RESILIENT_BAND_ROWS,
                                     device=DEVICE)
        os.environ["RRAY_FAIL_AFTER_BANDS"] = str(RESILIENT_FAIL_AFTER)
        subprocess.call = timed_call
        try:
            t0 = time.perf_counter()
            rc = api.render_resilient(
                path, WIDTH, HEIGHT, png, band_rows=RESILIENT_BAND_ROWS,
                checkpoint_path=os.path.join(tmp, "frame.npz"), attempts=4,
                device=DEVICE)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            subprocess.call = call
            del os.environ["RRAY_FAIL_AFTER_BANDS"]
        with open(png, "rb") as f, open(want_png, "rb") as g:
            same = rc == 0 and f.read() == g.read()
    per_child = ", ".join(f"{ms:.1f} ms (rc {c})" for ms, c in children)
    print(f"resilient example1 {WIDTH}x{HEIGHT}, {bands} bands, children "
          f"killed after {RESILIENT_FAIL_AFTER}: rc {rc}, {len(children)} "
          f"children: {per_child}; {wall:.1f} ms wall [{card_state()}]")
    if not same or len(children) < -(-bands // RESILIENT_FAIL_AFTER):
        fail(f"render_resilient: rc {rc}, {len(children)} children, PNG "
             f"equal to the progressive PNG: {same}")
    print("resilient example1: PNG bytes equal to the in-process "
          "progressive PNG")


def sharded_worker(rank, world, port, scene_paths, out):
    """One rank of the sharded phase (started with spawn): gloo over
    localhost, every rank on cuda:0. Renders each SHARDED_RUNS scene with
    render_sharded twice, the second time timed with the launch counts
    set to 0 just before it; takes SHARD_TRAIN_STEPS sharded Adam steps
    on example1 (forward, backward and all-reduce ms per step); checks
    the values of gloo's collectives on CUDA tensors; saves it all to
    `out`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.parallel import distributed, mesh as pmesh, train
    from rray_tpu_torch.render import integrator

    distributed.init_distributed(f"localhost:{port}", world, rank,
                                 backend="gloo")
    mesh = pmesh.make_mesh(f"{DEVICE}:0")
    settings = RenderSettings()
    res = {}
    for name, _ in SHARDED_RUNS:
        scene, cam = camera_data(scene_paths[name], torch)
        pmesh.render_sharded(scene, cam, mesh, settings)
        dist.barrier()
        launch_counts(reset=True)
        image, ms = timed(torch, pmesh.render_sharded, scene, cam, mesh,
                          settings)
        res[f"counts_{name}"] = json.dumps(launch_counts())
        res[f"ms_{name}"] = ms
        res[f"frame_{name}"] = image.cpu().numpy()

    scene, cam = camera_data(scene_paths["example1"], torch)
    with torch.no_grad():
        target = integrator.render(scene, cam, settings)
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    state, rest = train.init_train_state(corrupted(torch, scene), adam,
                                         trainable)
    step = train.make_train_step(rest, cam, settings, adam, mesh=mesh)
    ms = {"forward": [], "all-reduce": []}
    render_loss, all_reduce = train.render_loss, train.all_reduce_grads

    def timed_as(key, fn):
        def run(*args, **kwargs):
            out, t = timed(torch, fn, *args, **kwargs)
            ms[key].append(t)
            return out
        return run

    train.render_loss = timed_as("forward", render_loss)
    train.all_reduce_grads = timed_as("all-reduce", all_reduce)
    launch_counts(reset=True)
    steps = []
    try:
        for i in range(SHARD_TRAIN_STEPS):
            dist.barrier()
            (state, loss), total = timed(torch, step, state, target)
            steps.append({"forward": ms["forward"][i],
                          "backward": total - ms["forward"][i]
                          - ms["all-reduce"][i],
                          "all-reduce": ms["all-reduce"][i]})
            res[f"loss_{i}"] = float(loss)
            for k, t in state.params.items():
                res[f"grad_{i}_{k}"] = t.grad.cpu().numpy()
    finally:
        train.render_loss, train.all_reduce_grads = render_loss, all_reduce
    res["counts_train"] = json.dumps(launch_counts())
    res["train_ms"] = json.dumps(steps)
    for k, t in state.params.items():
        res[f"param_{k}"] = t.detach().cpu().numpy()

    # Which collectives gloo takes on CUDA tensors, and their values.
    x = torch.full((4,), float(rank + 1), device=mesh.device)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    summed = x.clone()
    dist.all_reduce(summed)
    root = x.clone()
    dist.broadcast(root, 0)
    want = torch.arange(1, world + 1, dtype=x.dtype, device=x.device)
    res["gloo_cuda"] = json.dumps({
        "all_gather": bool((torch.stack(parts)[:, 0] == want).all()),
        "all_reduce": bool((summed == want.sum()).all()),
        "broadcast": bool((root == 1).all())})
    np.savez(out, **res)
    dist.destroy_process_group()


def sharded_phase(torch, np, scene_paths, images):
    """Two ranks on the card (torch.multiprocessing, spawn; gloo): each
    SHARDED_RUNS frame equal on both ranks bit for bit, equal to the
    single-process main-path frame bit for bit on the kernel route and
    at the main path's image thresholds on the torch nodes, with the
    ranks' launch counts; each sharded train step's loss and gradients
    against the single-process step's (SHARD_RTOL), the parameters
    equal on both ranks -> the launch counts of both ranks' timed
    renders."""
    import socket

    import torch.multiprocessing as mp

    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.parallel import train
    from rray_tpu_torch.render import integrator

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz")
                for r in range(SHARDED_WORLD)]
        t0 = time.perf_counter()
        ctx = mp.start_processes(_sharded_entry, args=(
            SHARDED_WORLD, port, scene_paths, outs), nprocs=SHARDED_WORLD,
            join=False, start_method="spawn")
        deadline = time.perf_counter() + SHARDED_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"sharded: the ranks ran past {SHARDED_TIMEOUT_S} s")
        wall = (time.perf_counter() - t0) * 1e3
        ranks = [dict(np.load(o)) for o in outs]
    gloo = json.loads(str(ranks[0]["gloo_cuda"]))
    print(f"sharded: {SHARDED_WORLD} ranks on cuda:0 over gloo, spawned, "
          f"{wall:.1f} ms wall for the phase's processes; gloo on CUDA "
          f"tensors, values right: {json.dumps(gloo)}")
    if not all(gloo.values()):
        fail(f"gloo's collectives on CUDA tensors: {gloo}")
    total = launch_counts(reset=True)
    for name, expect in SHARDED_RUNS:
        frames = [r[f"frame_{name}"] for r in ranks]
        if not all(np.array_equal(frames[0], f) for f in frames[1:]):
            fail(f"sharded {name}: the ranks' frames differ")
        single = images[(name, 1)]
        scene, _ = camera_data(scene_paths[name], torch, (8, 6))
        node = integrator.route(scene)
        exact = np.array_equal(frames[0], single)
        if node == "kernel" and not exact:
            fail(f"sharded {name}: the frame is not the single-process "
                 f"frame bit for bit")
        diff = compare_images(torch, torch.from_numpy(frames[0]).unbind(-1),
                              torch.from_numpy(single).unbind(-1),
                              f"sharded {name}")
        counts = [json.loads(str(r[f"counts_{name}"])) for r in ranks]
        for rank, c in enumerate(counts):
            for kname in expect:
                if c[kname] < 1:
                    fail(f"sharded {name}: rank {rank} launched {kname} "
                         f"{c[kname]} times")
            total = {k: total[k] + c[k] for k in total}
        print(f"sharded {name} {WIDTH}x{HEIGHT} (route {node}): ranks equal "
              f"bit for bit; vs the single-process frame: "
              f"{'bit for bit' if exact else f'max |diff| {diff:.3e}'}; "
              f"render_sharded ms per rank (second call) "
              f"{[round(float(r[f'ms_{name}']), 3) for r in ranks]}; "
              f"launches per rank "
              f"{[{k: n for k, n in c.items() if n} for c in counts]} "
              f"[{card_state()}]")

    scene, cam = camera_data(scene_paths["example1"], torch)
    settings = RenderSettings()
    with torch.no_grad():
        target = integrator.render(scene, cam, settings)
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    state, rest = train.init_train_state(corrupted(torch, scene), adam,
                                         trainable)
    step = train.make_train_step(rest, cam, settings, adam)
    times = [json.loads(str(r["train_ms"])) for r in ranks]
    for i in range(SHARD_TRAIN_STEPS):
        (state, loss), single_ms = timed(torch, step, state, target)
        sharded_loss = float(ranks[0][f"loss_{i}"])
        worst = abs(sharded_loss - float(loss)) / abs(float(loss))
        for k, t in state.params.items():
            g = t.grad.cpu().numpy()
            diff = float(np.abs(ranks[0][f"grad_{i}_{k}"] - g).max())
            scale = float(np.abs(g).max())
            if diff > SHARD_RTOL * scale:
                fail(f"sharded train step {i}: {k} gradient max |diff| "
                     f"{diff:.3e}, largest gradient {scale:.3e}")
            worst = max(worst, diff / scale if scale else 0.0)
        if worst > SHARD_RTOL:
            fail(f"sharded train step {i}: loss {sharded_loss} vs "
                 f"{float(loss)}")
        print(f"sharded train example1 {WIDTH}x{HEIGHT} step {i}, Adam over "
              f"{SHARDED_WORLD} ranks on one card: loss {sharded_loss:.6e} "
              f"(single process {float(loss):.6e}), max relative difference "
              f"of the loss and the gradients {worst:.3e} (bound "
              f"{SHARD_RTOL}); ms per rank "
              f"{[{k: round(v, 3) for k, v in t[i].items()} for t in times]} "
              f"(single-process step {single_ms:.3f} ms) [{card_state()}]")
    for k in state.params:
        if not all(np.array_equal(r[f"param_{k}"], ranks[0][f"param_{k}"])
                   for r in ranks[1:]):
            fail(f"sharded train: the ranks' {k} differ after the steps")
    counts = [json.loads(str(r["counts_train"])) for r in ranks]
    print(f"sharded train: parameters equal on the ranks; launches per rank "
          f"{[{k: n for k, n in c.items() if n} for c in counts]}")
    if not all(c["whitted_compact"] >= SHARD_TRAIN_STEPS for c in counts):
        fail(f"sharded train: whitted launches per rank {counts}")
    return total


def _sharded_entry(rank, world, port, scene_paths, outs):
    sharded_worker(rank, world, port, scene_paths, outs[rank])


@contextlib.contextmanager
def per_entry_counts(tallies):
    """Tally every kernel-module counter (kernels/build.py count) by the
    row block whose integrator.render_block is running (a local mesh
    runs its entries in turn): tallies[r0]["<module>.<counter>"] (the
    module counters count as before)."""
    from rray_tpu_torch.kernels import build
    from rray_tpu_torch.render import integrator

    count, render_block = build.count, integrator.render_block
    current = [None]

    def counted(namespace, name):
        count(namespace, name)
        if current[0] is not None:
            key = f"{namespace['__name__'].rsplit('.', 1)[-1]}.{name}"
            entry = tallies.setdefault(current[0], {})
            entry[key] = entry.get(key, 0) + 1

    def block_of(scene, cam, r0, *args, **kwargs):
        current[0] = r0
        try:
            return render_block(scene, cam, r0, *args, **kwargs)
        finally:
            current[0] = None

    build.count, integrator.render_block = counted, block_of
    try:
        yield tallies
    finally:
        build.count, integrator.render_block = count, render_block


def local_mesh_phase(torch, np, scene_paths):
    """render_sharded over a local mesh (parallel/mesh.py make_mesh(
    devices=...)): LOCAL_ENTRIES entries in this process, entry i on
    cuda:(i % n). Each LOCAL_RUNS frame against the single-process
    frame of a fresh copy of the scene, bit for bit, with wall ms of the
    first calls (tables built) and the second (tables kept), the first
    call's launches and table builds per entry, and peak memory per
    card; one local-mesh
    Adam step on example1 against the single-process step; and the
    default compute API (compile_scene and compile_camera with no device)
    rendering glass on the card with one whitted launch -> the launch
    counts of the mesh frames' first calls."""
    from rray_tpu_torch import compile_camera, compile_scene, render
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.parallel import mesh as pmesh, train
    from rray_tpu_torch.render import integrator
    from rray_tpu_torch.render.camera import Camera

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    mesh = pmesh.make_mesh(devices=[f"{DEVICE}:{i % n}"
                                    for i in range(LOCAL_ENTRIES)])
    cards = sorted({d.index for d in mesh.devices})
    settings = RenderSettings()

    def peaks():
        return [round(torch.cuda.max_memory_allocated(c) / 2 ** 20, 1)
                for c in cards]

    def reset_peaks():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    def single_frame(scene, cam):
        with torch.no_grad():
            return integrator.render(scene, cam, settings)

    total = launch_counts(reset=True)
    for name, expect in LOCAL_RUNS:
        scene, cam = camera_data(scene_paths[name], torch, (WIDTH, HEIGHT))
        fresh = pmesh.replica(scene, mesh.device)
        reset_peaks()
        single, single_ms = timed(torch, single_frame, fresh, cam)
        single_peak = peaks()
        _, single_ms2 = timed(torch, single_frame, fresh, cam)
        reset_peaks()
        tallies = {}
        launch_counts(reset=True)
        with per_entry_counts(tallies):
            image, ms = timed(torch, pmesh.render_sharded, scene, cam, mesh,
                              settings)
        counts = launch_counts()
        peak = peaks()
        _, ms2 = timed(torch, pmesh.render_sharded, scene, cam, mesh,
                       settings)
        if image.device != single.device or not torch.equal(image, single):
            diff = float((image.to(single.device) - single).abs().max())
            fail(f"local mesh {name}: the frame on {image.device} is not "
                 f"the single-process frame bit for bit (max |diff| "
                 f"{diff:.3e})")
        for kname in expect:
            if counts[kname] < 1:
                fail(f"local mesh {name}: {kname} launched {counts[kname]} "
                     f"times")
        entries = [tallies.get(pmesh.row_block(cam.vsize, mesh, i)[0], {})
                   for i in range(LOCAL_ENTRIES)]
        print(f"local mesh {name} {WIDTH}x{HEIGHT} (route "
              f"{integrator.route(scene)}): {LOCAL_ENTRIES} entries on "
              f"{len(cards)} distinct card(s) of n={n}, bit for bit the "
              f"single-process frame; render_sharded {ms:.1f} ms wall "
              f"(second call {ms2:.1f} ms) against the single frame's "
              f"{single_ms:.1f} ms (second call {single_ms2:.1f} ms); "
              f"first call's launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}; per "
              f"entry launches and table builds {json.dumps(entries)}; peak "
              f"memory per card {peak} MiB (single frame {single_peak} MiB) "
              f"[{card_state()}]")
        total = {k: total[k] + counts[k] for k in total}
        del scene, fresh, cam, single, image
        torch.cuda.empty_cache()

    scene, cam = camera_data(scene_paths["example1"], torch, (WIDTH, HEIGHT))
    target = single_frame(scene, cam)
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    steps = {}
    for key, step_mesh in (("single", None), ("local", mesh)):
        state, rest = train.init_train_state(corrupted(torch, scene), adam,
                                             trainable)
        step = train.make_train_step(rest, cam, settings, adam,
                                     mesh=step_mesh)
        launch_counts(reset=True)
        (state, loss), step_ms = timed(torch, step, state, target)
        steps[key] = (float(loss), {k: t.grad.cpu().numpy()
                                    for k, t in state.params.items()},
                      step_ms, launch_counts()["whitted_compact"])
    (loss1, grads1, ms1, n1), (loss4, grads4, ms4, n4) = (
        steps["single"], steps["local"])
    worst = abs(loss4 - loss1) / abs(loss1)
    for k, g in grads1.items():
        diff = float(np.abs(grads4[k] - g).max())
        scale = float(np.abs(g).max())
        if diff > SHARD_RTOL * scale:
            fail(f"local mesh train step: {k} gradient max |diff| "
                 f"{diff:.3e}, largest gradient {scale:.3e}")
        worst = max(worst, diff / scale if scale else 0.0)
    if worst > SHARD_RTOL or n4 < LOCAL_ENTRIES:
        fail(f"local mesh train step: loss {loss4} vs {loss1}, whitted "
             f"launches {n4}")
    print(f"local mesh train example1 {WIDTH}x{HEIGHT}, one Adam step over "
          f"{LOCAL_ENTRIES} entries: loss {loss4:.6e} (single process "
          f"{loss1:.6e}), max relative difference of the loss and the "
          f"gradients {worst:.3e} (bound {SHARD_RTOL}); step {ms4:.1f} ms "
          f"(single process {ms1:.1f} ms); whitted launches {n4} "
          f"(single {n1}) [{card_state()}]")

    spec, lights, shapes = load_scene_file(scene_paths["glass"])
    camera = Camera(WIDTH, HEIGHT, spec["fov"])
    camera.transform = spec["transform"]
    launch_counts(reset=True)
    with torch.no_grad():
        image = render(compile_scene(shapes, lights), compile_camera(camera))
    counts = launch_counts()
    glass, glass_cam = camera_data(scene_paths["glass"], torch,
                                   (WIDTH, HEIGHT))
    if not image.is_cuda or counts["whitted_compact"] != 1 or \
            not torch.equal(image, single_frame(glass, glass_cam)):
        fail(f"render(compile_scene(...), compile_camera(...)) with no "
             f"device: {image.device}, launches {counts}")
    print(f"default compute API: render(compile_scene(shapes, lights), "
          f"compile_camera(cam)) on glass -> {image.device}, launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}, equal to "
          f"the explicit-device frame")
    torch.cuda.empty_cache()
    print(f"local mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def profile_phase(torch, scene_paths):
    """utils.profiling.trace around one main-path glass render: the
    Chrome trace exists and names the whitted kernel; prints
    live_arrays_bytes()."""
    import glob

    from rray_tpu_torch import api
    from rray_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            api.render_scene_from_file(scene_paths["glass"], WIDTH, HEIGHT,
                                       os.path.join(tmp, "glass.png"),
                                       device=DEVICE)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        if len(files) != 1:
            fail(f"profiling.trace wrote {files}")
        with open(files[0]) as f:
            text = f.read()
    if "whitted_kernel" not in text:
        fail("the profile's trace does not name the whitted kernel")
    print(f"profile glass {WIDTH}x{HEIGHT}: Chrome trace of {len(text)} "
          f"bytes names whitted_kernel; live_arrays_bytes() "
          f"{profiling.live_arrays_bytes()}")



def whitted_blocks():
    """Resident blocks per SM of every whitted instantiation with no
    dynamic shared memory (the occupancy calculator, so by registers),
    keyed as print_ptxas names them: whitted_kernel<W, ext, KB>."""
    from rray_tpu_torch.kernels import whitted

    cases = [(W, False, 0) for W in whitted.WIDTHS]
    cases += [(1, True, kb) for kb in whitted.SLOT_BUCKETS]
    cases += [(W, True, 0) for W in whitted.WIDTHS if W > 1]
    return {f"whitted_kernel<{W}, {int(ext)}, {kb}>":
            whitted.blocks_per_sm(W, ext, kb, 0) for W, ext, kb in cases}


def print_ptxas(log, blocks=None):
    """Registers, stack and spills of every kernel instantiation, from
    ptxas -v (stage e: the whitted kernels with ext = 1, then the CSG
    slot bucket), with `blocks` per SM beside the register line."""
    import re

    blocks = blocks or {}
    props = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?",
                      props or "")
        if not m:
            continue
        name = m.group(1)
        if m.group(2):
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            name += "<" + ", ".join(args) + ">"
        if "stack frame" in line or "registers" in line:
            extra = (f", {blocks[name]} blocks/SM (occupancy, no dynamic "
                     f"shared memory)" if "registers" in line
                     and name in blocks else "")
            print(f"  ptxas {name}: {line.split(':')[-1].strip()}{extra}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import numpy as np

    from rray_tpu_torch import api
    from rray_tpu_torch.io import mesh_scenes
    from rray_tpu_torch.kernels import build, whitted
    from rray_tpu_torch.render import canvas, integrator

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
    print_ptxas(info["log"], whitted_blocks())

    tmp = tempfile.TemporaryDirectory()
    scene_paths = {name: os.path.join(ROOT, path) for name, path in EXAMPLES}
    scene_paths.update({name: mesh_scenes.write_scene(tmp.name, name, **kw)
                        for name, kw in {**SCENES, **PHASE_SCENES}.items()})
    scene_paths.update({name: mesh_scenes.write_config5(tmp.name, name, **kw)
                        for name, kw in CONFIG5.items()})
    for name, want in (("csg", "kernel"), ("csg5r", "kernel"),
                       ("tex5r", "fast")):
        scene = camera_scene(scene_paths[name], torch, size=(8, 6))[0]
        if integrator.route(scene) != want or not whitted.needs_ext(scene):
            fail(f"{name} routes to {integrator.route(scene)}, not {want}, "
                 f"or needs no stage e")
    for name in SORTED:
        scene = camera_scene(scene_paths[name], torch, size=(8, 6))[0]
        print(f"route {name}: {integrator.route(scene)}")
        if integrator.route(scene) != "sorted":
            fail(f"{name} routes to {integrator.route(scene)}, not sorted")

    results = {}
    for name, aa in (("glass", 1), ("example1", 1), ("mesh4", 1),
                     ("mesh4r", 1), ("area", 3), ("area4", 1), ("csg", 1),
                     ("csg5r", 1)):
        whitted_phase(torch, name, scene_paths[name], results, aa)
    whitted_phase(torch, "csg", scene_paths["csg"], results, 5, CSG_STRIDE)
    main_launch_phase(torch, scene_paths["csg"], results)
    triangle_phase(torch, "mesh9", scene_paths["mesh9"], results,
                   yardstick=True)
    for name in ("mesh9k", "mesh4b"):
        triangle_phase(torch, name, scene_paths[name], results)
    shadow_call_phase(torch, "area4b", scene_paths["area4b"], results)
    shadow_call_phase(torch, "area9", scene_paths["area9"], results)
    triangle_phase(torch, "mesh50b", scene_paths["mesh50b"], results)
    area_phase(torch, "area21", scene_paths["area21"], results)
    area_phase(torch, "area801 200x150", scene_paths["area801"], results,
               (200, 150), timed=False)

    images, counts = main_path(torch, np, scene_paths)
    box = downsample_phase(torch, np)
    png = png_phase(torch, np, scene_paths)
    # Main-path images against the plain versions': the whitted kernel's
    # scenes against whitted_compact_reference (area at aa=3 against the
    # plain image of the 4.32 M rays above, downsampled), the fast node's
    # against the same node with the plain kernel versions.
    for name, aa in (("glass", 1), ("example1", 1), ("mesh4", 1),
                     ("mesh4r", 1), ("area", 3), ("area4", 1), ("csg5r", 1)):
        res = results["whitted"][name]
        plain = torch.stack(res["plain"], -1).reshape(HEIGHT * aa,
                                                      WIDTH * aa, 3)
        plain = torch.from_numpy(canvas.downsample(plain.cpu().numpy(), aa))
        img = torch.from_numpy(images[(name, aa)])
        compare_images(torch, img.to(DEVICE).unbind(-1),
                       plain.to(DEVICE).unbind(-1),
                       f"main path {name} aa={aa}")
    plain = whitted_plain_image(torch, np, scene_paths["area"], 1)
    diff = compare_images(
        torch, torch.from_numpy(images[("area", 1)]).to(DEVICE).unbind(-1),
        torch.from_numpy(plain).to(DEVICE).unbind(-1), "main path area aa=1")
    print(f"parity main path area aa=1: max |kernel - plain| {diff:.3e}")
    for name in ("mesh9", "mesh4b", "area21", "area4b", "area9") + SORTED:
        w, h = size_of(name)
        image = images[(name, 1)]
        if name in HALF_SIZE_PLAIN:
            # The plain BVH and area-shadow versions take 12-25 s at the
            # main path's size: compare a render with the kernels at half
            # its width and height instead (not a main-path run).
            w, h = w // 2, h // 2
            image = api.render_scene_from_file(scene_paths[name], w, h, "",
                                               device=DEVICE)
        t0 = time.perf_counter()
        with plain_kernels():
            plain = api.render_scene_from_file(scene_paths[name], w, h, "",
                                               device=DEVICE)
        wall = time.perf_counter() - t0
        diff = compare_images(
            torch, torch.from_numpy(image).to(DEVICE).unbind(-1),
            torch.from_numpy(plain).to(DEVICE).unbind(-1), f"main path {name}")
        print(f"parity main path {name} {w}x{h}: max |kernels - plain| "
              f"{diff:.3e} (plain-kernel frame {wall * 1e3:.1f} ms wall)")
    oracle = oracle_phase(torch, np, scene_paths, card)
    unrolled = unrolled_phase(torch, np, scene_paths, card)
    for name, aa, reps in (("mesh4", 1, 5), ("mesh9", 1, 5), ("mesh4b", 1, 5),
                           ("area", 3, 5), ("csg", 5, 3), ("glass4", 1, 3),
                           ("csgglass", 1, 3)):
        frame_breakdown(torch, np, name, scene_paths[name], aa, reps)
    grad_parity_phase(torch, scene_paths)
    train_phase(torch, scene_paths)
    prog = progressive_phase(torch, np, scene_paths, images)
    resilient_phase(np, scene_paths)
    sharded = sharded_phase(torch, np, scene_paths, images)
    local = local_mesh_phase(torch, np, scene_paths)
    profile_phase(torch, scene_paths)
    tmp.cleanup()
    # The JSON line's launches: the main path's runs, the oracle's routed
    # frames, the unrolled runs, the progressive frames', both ranks'
    # sharded frames' and the local mesh's frames', each counted from 0.
    counts = {k: counts[k] + oracle[k] + unrolled[k] + prog[k] + sharded[k]
              + local[k] for k in counts}

    # Times on the card, in turns.
    kernels = []
    for name, res in results["whitted"].items():
        if not res["timed"]:
            continue
        fn = functools.partial(whitted.whitted_compact, *res["rays"],
                               **res["inputs"], **res["raster"])
        plain_fn = functools.partial(whitted.whitted_compact_reference,
                                     *res["rays"], **res["inputs"])
        res["ms"], res["call_ms"], res["plain_ms"] = timed_turns(
            torch, f"whitted_compact {name}", "whitted_kernel", fn, plain_fn)
        w, h = (n * res["aa"] for n in res["size"])
        print(f"time whitted_compact {name} {w}x{h}: kernel "
              f"{res['ms']:.4f} ms/frame ({w * h / res['ms'] * 1e3:.4g} "
              f"primary rays/s), call {res['call_ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms/frame, bound {res['bound'][0]:.5f} "
              f"ms over all levels ({res['bound'][2]}), "
              f"{res['bound_primary'][0]:.5f} ms for the primary level "
              f"alone, {whitted.last_launch['blocks_per_sm']} blocks/SM, "
              f"{whitted.last_launch['smem']} B dynamic shared memory "
              f"[{card}]")
    device_names = {"closest_triangle": "closest_kernel",
                    "any_triangle": "any_kernel",
                    "bvh_closest_triangle": "bvh_",
                    "area_shadow_fraction": "area_kernel"}
    for kname, dname in device_names.items():
        for res in results[kname]:
            res["ms"], res["call_ms"], res["plain_ms"] = timed_turns(
                torch, f"{kname} {res['what']}", dname, res["fn"],
                res["plain_fn"])
            print(f"time {kname} {res['what']} {WIDTH}x{HEIGHT}: kernel "
                  f"{res['ms']:.5f} ms, call {res['call_ms']:.5f} ms, plain "
                  f"{res['plain_ms']:.4f} ms, bound {res['bound'][0]:.5f} ms "
                  f"({res['bound'][2]}) [{card}]")

    for res in results["yardstick"]:
        _, reps = window_ms(torch, res["fn"])
        ms = kernel_ms(torch, res["fn"], "bvh_", reps)
        print(f"yardstick bvh_closest_triangle {res['what']} (card_tables; "
              f"not a route): kernel {ms:.5f} ms on the device [{card}]")

    sources = {"whitted_compact": ("whitted.cu", "whitted.py:1464"),
               "closest_triangle": ("triangles.cu", "triangles.py:385"),
               "any_triangle": ("triangles.cu", "triangles.py:320"),
               "bvh_closest_triangle": ("bvh.cu", "bvh.py:558"),
               "area_shadow_fraction": ("area.cu", "analytic.py:144")}
    for kname, (src, tpu) in sources.items():
        if kname == "whitted_compact":  # config 5's main-path launch
            res = results["whitted main"]
            err = max([r["max_abs"] for r in results["whitted"].values()]
                      + [res["max_abs"]])
        else:
            res = results[kname][0]
            err = max(r["max_abs"] for r in results[kname])
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"rray_tpu_torch/kernels/csrc/{src}",
            "replaces": f"rray_tpu/kernels/{tpu}",
            "launches": counts[kname], "max_abs_err": err,
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
            "library_ms": None})
    # The port's own kernel: it replaces no TPU kernel (rray_tpu takes the
    # mean on the host); its yardstick is torch.mean, not the same bits.
    kernels.append({
        "name": "downsample", "route": "cuda",
        "source": "rray_tpu_torch/kernels/csrc/downsample.cu",
        "replaces": None, "launches": counts["downsample"],
        "max_abs_err": box["max_abs"], "ms": box["ms"],
        "plain_ms": box["plain_ms"], "bound_ms": box["bound"][0],
        "bound_by": box["bound"][1], "library_ms": box["mean_ms"]})
    # The match search replaces no TPU kernel either (rray_tpu deflates on
    # the host); at config 5's size, with zlib's compress2 beside it.
    res = png["csg"]
    kernels.append({
        "name": "deflate_match", "route": "cuda",
        "source": "rray_tpu_torch/kernels/csrc/deflate.cu",
        "replaces": None, "launches": counts["deflate_match"],
        "max_abs_err": res["max_abs"], "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "library_ms": None, "emitter_ms": res["emit_ms"],
        "compress2_ms": res["zlib_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
