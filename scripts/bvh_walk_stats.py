#!/usr/bin/env python3
"""Count the BVH walk's work per ray on the host: node visits, leaves and
triangle tests of one ray walking the card's tree alone.

    python3 scripts/bvh_walk_stats.py [--size 800x600] [--leaves 4,8,16]
        [--scenes mesh4b,mesh50b]

The walk is rray_tpu_torch/kernels/csrc/mesh_device.cuh `bvh_walk`,
compiled as host C++ (g++, -ffp-contract=off) with counters added to a
copy in a temporary directory; on the host a warp is one lane, so each
ray walks alone. The rays are the camera rays of chip_smoke.py's mesh
scenes, closest hit bounded by the analytic hit as the fast node calls
it. Per scene and leaf size the script prints the mean visits, leaves
and triangle tests per ray, their 99th percentile and maximum, and, for
32 consecutive rays, the slowest ray's cost over the mean (a node visit
weighted 100, a triangle test 60): the work a lone walk per thread
leaves to its warp's slowest lane. Needs g++; no card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "rray_tpu_torch", "kernels", "csrc")
# (old text, new text) of mesh_device.cuh: counters on visits, leaves and
# triangle tests.
COUNTERS = (
    ("namespace rray {", "namespace rray {\nlong g_visits, g_leaves, g_tris;"),
    ("  bool hit = false;\n  for (int i = r0; i < r1; ++i) {",
     "  bool hit = false;\n  g_leaves += on;\n"
     "  for (int i = r0; i < r1; ++i) {\n    g_tris += on;"),
    ("    const float* row = nodes + (size_t)n * BVH_NODE;\n",
     "    g_visits++;\n    const float* row = nodes + (size_t)n * BVH_NODE;\n"),
)
HARNESS = r"""
#include <math.h>
#include <string.h>
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#define RRAY_DEVICE inline
#define RRAY_NOINLINE
#include "mesh_device.cuh"
using namespace rray;
extern "C" void walk_all(const float* const* rays, const float* dist,
                         const float* block, int node_words, int T, int Lp,
                         int leaf, long* out, int R) {
  for (int i = 0; i < R; ++i) {
    g_visits = g_leaves = g_tris = 0;
    bvh_walk(block, block + node_words, T, Lp, leaf,
             v3(rays[0][i], rays[1][i], rays[2][i]),
             v3(rays[3][i], rays[4][i], rays[5][i]), dist[i], false, true);
    out[3 * i] = g_visits;
    out[3 * i + 1] = g_leaves;
    out[3 * i + 2] = g_tris;
  }
}
"""


def build(tmp: str):
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, name), tmp)
    path = os.path.join(tmp, "mesh_device.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in COUNTERS:
        if src.count(old) != 1:
            raise SystemExit(f"mesh_device.cuh has {src.count(old)} copies "
                             f"of {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    with open(os.path.join(tmp, "h.cpp"), "w") as f:
        f.write(HARNESS)
    lib = os.path.join(tmp, "libh.so")
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", tmp, "-o", lib,
                    os.path.join(tmp, "h.cpp")], check=True)
    return ctypes.CDLL(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="800x600")
    ap.add_argument("--leaves", default="4,8,16")
    ap.add_argument("--scenes", default="mesh4b,mesh50b")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from rray_tpu_torch.io import mesh_scenes
    from rray_tpu_torch.kernels import bvh
    from rray_tpu_torch.ops import soa

    cs.DEVICE = "cpu"
    w, h = (int(x) for x in args.size.split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        kw = {**cs.SCENES, **cs.PHASE_SCENES}
        for name in args.scenes.split(","):
            path = mesh_scenes.write_scene(tmp, name, **kw[name])
            scene, (ro, rd) = cs.camera_scene(path, torch, size=(w, h))
            t_an = np.ascontiguousarray(
                soa.analytic_closest(scene, ro, rd)[0].numpy())
            rays = [np.ascontiguousarray(c.numpy())
                    for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
            ptrs = (ctypes.c_void_p * 6)(*(a.ctypes.data for a in rays))
            R = rays[0].shape[0]
            for leaf in (int(x) for x in args.leaves.split(",")):
                t = bvh.card_tables(soa._tri_comps(scene, False), (), leaf)
                block = t.block.numpy()
                out = np.zeros((R, 3), np.int64)
                lib.walk_all(ptrs, ctypes.c_void_p(t_an.ctypes.data),
                             ctypes.c_void_p(block.ctypes.data),
                             t.Lp * bvh.NODE, t.T, t.Lp, leaf,
                             ctypes.c_void_p(out.ctypes.data), R)
                cost = out[:, 0] * 100 + out[:, 2] * 60
                cost = cost[:R // 32 * 32].reshape(-1, 32)
                stats = ", ".join(
                    f"{what} mean {out[:, k].mean():.2f} p99 "
                    f"{np.percentile(out[:, k], 99):.0f} max {out[:, k].max()}"
                    for k, what in enumerate(("visits", "leaves",
                                              "triangles")))
                print(f"walk {name} ({t.T} triangles) {w}x{h} leaf {leaf}: "
                      f"{stats} per ray; slowest of 32 rays / mean "
                      f"{cost.max(1).sum() / cost.mean(1).sum():.2f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
