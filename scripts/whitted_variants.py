#!/usr/bin/env python3
"""Write variants of this checkout's kernels for whitted_ab.py and
fast_ab.py.

    python3 scripts/whitted_variants.py [OUT] [--only a,b]

Each variant is a copy of `rray_tpu_torch/` under OUT/<name>/ (default
build/variants, which .gitignore lists) with one design choice of
a kernel undone or changed, so that whitted_ab.py (the whitted kernel)
or fast_ab.py (the BVH kernel) can time the shipped kernel against it in
turns on one card:

    grid      one 16x8 tile per block (no persistent grid): every block
              stages the tables itself and the hardware hands out tiles
    stride    persistent, each block taking every gridDim-th tile (a
              fixed stride) instead of the next untaken one
    mb5, mb6  __launch_bounds__ asking for 5 or 6 resident blocks of the
              stage-e kernels at W = 1
    meshg     the mesh rows and chunk boxes read from global memory
              instead of shared memory (stage d's other layout)
    qinline   the torus quartic inlined at each call site
    noq       diagnostic, not a kernel: the torus quartic returns no
              roots (images differ), to show the quartic's share
    bvhmiss   diagnostic: the BVH walk returns a miss at once (the cost of
              reading rays and writing outputs)
    bvhnoleaf diagnostic: the BVH walk tests no triangle (the cost of the
              node visits alone)
    bvh512    the BVH kernel's persistent staged grid with blocks of 512
              threads (16 warps per SM) instead of 1024
    areadraw  diagnostic: the area-shadow body draws every sample and
              tests no prim (the cost of the draws)
    areanocull the area-shadow body without its cull (every prim tested)
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("rray_tpu_torch", "kernels", "csrc")

# variant -> [(file under rray_tpu_torch/.., old text, new text)]
PATCHES = {
    "grid": [(f"{CSRC}/whitted.cu",
              "const int grid = sms * per_sm < tiles ? sms * per_sm : tiles;",
              "const int grid = tiles;")],
    "stride": [(f"{CSRC}/whitted.cu", "    tile = next[k & 1];",
                "    tile += gridDim.x;")],
    "mb5": [(f"{CSRC}/whitted.cu",
             "constexpr int min_blocks() {\n  return 1;",
             "constexpr int min_blocks() {\n  return W == 1 && kExt ? 5 : 1;")],
    "mb6": [(f"{CSRC}/whitted.cu",
             "constexpr int min_blocks() {\n  return 1;",
             "constexpr int min_blocks() {\n  return W == 1 && kExt ? 6 : 1;")],
    "meshg": [
        (f"{CSRC}/whitted_device.cuh",
         "  const float* texels;  // flat texel table (global memory), or null\n};",
         "  const float* texels;  // flat texel table (global memory), or null\n"
         "  const float* gtables;\n};"),
        (f"{CSRC}/whitted_device.cuh",
         "RRAY_DEVICE const float* tris() const { return w + d->w[D_TRIS]; }",
         "RRAY_DEVICE const float* tris() const { return d->gtables + d->w[D_TRIS]; }"),
        (f"{CSRC}/whitted_device.cuh",
         "RRAY_DEVICE const float* tboxes() const { return w + d->w[D_TBOXES]; }",
         "RRAY_DEVICE const float* tboxes() const { return d->gtables + d->w[D_TBOXES]; }"),
        (f"{CSRC}/whitted.cu",
         "  a.desc.texels = texels;",
         "  a.desc.texels = texels;\n  a.desc.gtables = tables;"),
        (f"{CSRC}/whitted.cu",
         "  const int words = desc.w[rray::D_WORDS];",
         "  const int words = desc.w[rray::D_T] > 0 ? desc.w[rray::D_TRIS]"
         " : desc.w[rray::D_WORDS];"),
        ("rray_tpu_torch/kernels/whitted.py",
         "                        4 * desc[\"words\"] + stack, frames, sizes)",
         "                        4 * (desc[\"tris\"] if desc[\"T\"] else "
         "desc[\"words\"]) + stack, frames, sizes)")],
    "qinline": [(f"{CSRC}/quartic_device.cuh",
                 "static RRAY_NOINLINE Roots4 solve_quartic(",
                 "RRAY_DEVICE Roots4 solve_quartic(")],
    "bvhmiss": [(f"{CSRC}/mesh_device.cuh",
                 "  if (!warp_any(live)) return h;\n  if (Lp == 1) {",
                 "  if (limit == limit) return h;\n  if (Lp == 1) {")],
    "bvhnoleaf": [(f"{CSRC}/mesh_device.cuh",
                   "float limit, bool any_hit, bool on, TriHit* h) {\n",
                   "float limit, bool any_hit, bool on, TriHit* h) {\n"
                   "  if (limit == limit) return false;\n")],
    "bvh512": [(f"{CSRC}/bvh.cu",
                "constexpr int kStagedThreads = 1024;",
                "constexpr int kStagedThreads = 512;")],
    "areadraw": [(f"{CSRC}/whitted_device.cuh",
                  "    for (int j = 0; j < P && open; ++j) {",
                  "    for (int j = 0; j < (P & 0x40000000) && open; ++j) {")],
    "areanocull": [(f"{CSRC}/whitted_device.cuh",
                    "      if (b[6] != 0.0f && (b[0] > hi[0]",
                    "      if (b[6] != b[6] && (b[0] > hi[0]")],
    "noq": [(f"{CSRC}/quartic_device.cuh",
             "  float roots[4];\n  bool valids[4];",
             "  if (c4 == c4) {\n    Roots4 none = {{0.0f, 0.0f, 0.0f, 0.0f}, 0u};"
             "\n    return none;\n  }\n  float roots[4];\n  bool valids[4];")],
}


def write(out: str, name: str) -> str:
    dst = os.path.join(out, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "rray_tpu_torch"),
                    os.path.join(dst, "rray_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in PATCHES[name]:
        path = os.path.join(dst, rel)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {rel} has {src.count(old)} copies of "
                             f"{old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?",
                    default=os.path.join(ROOT, "build", "variants"))
    ap.add_argument("--only", default=",".join(PATCHES))
    args = ap.parse_args()
    for name in args.only.split(","):
        print(write(args.out, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
