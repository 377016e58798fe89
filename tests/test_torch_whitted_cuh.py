"""The CUDA kernel's device code against the plain version, on the CPU.

kernels/csrc/whitted_device.cuh holds everything one CUDA thread runs
(trace_ray<W> and the node, slot, shadow and pattern functions); it
needs only two function-qualifier macros and the C math library, so it
also compiles as host C++. Built here with g++ and -ffp-contract=off
(the host analogue of the kernel's --fmad=false), it is held against
`whitted_compact_reference` on camera rays. This checks the kernel's
arithmetic and control flow wherever there is no card; the CUDA build
itself is checked on the card by chip_smoke.py."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render.camera import Camera, all_rays_soa, compile_camera
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(BASE, "rray_tpu_torch", "kernels", "csrc")

HARNESS = r"""
#include <math.h>
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#define RRAY_DEVICE inline
#define RRAY_NOINLINE
#include "whitted_device.cuh"
using namespace rray;
template <int W>
static void run(const SceneView& s, const float* const* rays, float* const* out,
                int R, int depth, bool refl, bool refr) {
  for (int i = 0; i < R; ++i) {
    float rgb[3];
    trace_ray<W>(s, v3(rays[0][i], rays[1][i], rays[2][i]),
                 v3(rays[3][i], rays[4][i], rays[5][i]), depth, refl, refr, rgb);
    for (int c = 0; c < 3; ++c) out[c][i] = rgb[c];
  }
}
extern "C" void trace_all(const float* const* rays, float* const* out,
                          const float* prims, int P, const float* pats, int N,
                          const float* lights, int L, const int* ints, int R,
                          int depth, int W, int refl, int refr) {
  SceneView s;
  s.prims = prims; s.pats = pats; s.lights = lights; s.kinds = ints;
  s.roots = ints + P; s.ptype = ints + 2 * P; s.pa = s.ptype + N;
  s.pb = s.pa + N; s.P = P; s.L = L;
  switch (W) {
    case 1: run<1>(s, rays, out, R, depth, refl, refr); break;
    case 4: run<4>(s, rays, out, R, depth, refl, refr); break;
    case 32: run<32>(s, rays, out, R, depth, refl, refr); break;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the device code as host C++")
    d = tmp_path_factory.mktemp("cuh")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    return ctypes.CDLL(str(d / "libharness.so"))


def _host_trace(lib, rays, prim_tbl, pat_tbl, light_tbl, kinds, descrs,
                prim_pat, depth, W, refl, refr):
    R = rays[0].shape[0]
    arrs = [np.ascontiguousarray(r.numpy()) for r in rays]
    outs = [np.empty(R, np.float32) for _ in range(3)]
    tables = [np.ascontiguousarray(t.numpy()) for t in (prim_tbl, pat_tbl,
                                                        light_tbl)]
    ints = np.asarray(whitted.int_table(kinds, descrs, prim_pat,
                                        pat_tbl.shape[0]), np.int32)
    ptrs = lambda xs: (ctypes.c_void_p * len(xs))(
        *(x.ctypes.data for x in xs))
    c = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.trace_all(ptrs(arrs), ptrs(outs), c(tables[0]),
                  ctypes.c_int(len(kinds)), c(tables[1]),
                  ctypes.c_int(pat_tbl.shape[0]), c(tables[2]),
                  ctypes.c_int(light_tbl.shape[0]), c(ints), ctypes.c_int(R),
                  ctypes.c_int(depth), ctypes.c_int(W), ctypes.c_int(refl),
                  ctypes.c_int(refr))
    return np.stack(outs)


@pytest.mark.parametrize("name,cap", [("example1.yaml", 4), ("glass.yaml", 4),
                                      ("glass.yaml", 32)])
def test_device_code_matches_plain_version(host_lib, name, cap):
    cam_spec, lights, shapes = load_scene_file(
        os.path.join(BASE, "examples", name))
    scene = compile_scene(shapes, lights, dtype=torch.float32)
    cam = Camera(96, 72, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32))
    rays = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)
    pat_tbl, descrs = whitted.pack_patterns(scene)
    depth, W = whitted.wavefront_shape(
        scene, RenderSettings(wavefront_capacity=cap))
    args = (whitted.pack_prims(scene), pat_tbl, whitted.pack_lights(scene),
            scene.prim_kinds, descrs, scene.prim_pattern_static, depth, W,
            scene.has_reflective, scene.has_transparent)
    plain = np.stack([c.numpy() for c in whitted.whitted_compact_reference(
        rays[:3], rays[3:], *args)])
    host = _host_trace(host_lib, rays, *args)
    # Same operations in the same order; glibc's powf/sqrtf-based rsqrt
    # and PyTorch's vectorized pow/rsqrt may differ by an ulp, which the
    # shininess exponent can grow to ~1e-7 (measured max 1.3e-7). A
    # boundary decision flipped by such an ulp would exceed 1e-6: none
    # was measured, 0.1% of rays is allowed.
    diff = np.abs(host - plain).max(axis=0)
    assert np.isfinite(host).all()
    assert float((diff <= 1e-6).mean()) >= 0.999, diff.max()
