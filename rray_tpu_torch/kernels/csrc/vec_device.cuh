// Three-vectors and the reference's EPSILON for the per-ray device code
// of the port's kernels (whitted_device.cuh, mesh_device.cuh).
//
// Every function computes its expression in the order the plain PyTorch
// versions write it; the kernels are built with --fmad=false, so each
// product and sum rounds on its own, as in the plain versions. The
// headers need only the C math functions and two function-qualifier
// macros, RRAY_DEVICE (inlined) and RRAY_NOINLINE, so they also compile
// as host C++ (tests/test_torch_whitted_cuh.py).
#pragma once

#include <math.h>

namespace rray {

constexpr float EPSILON = 1e-5f;

struct V3 { float x, y, z; };

RRAY_DEVICE V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
RRAY_DEVICE V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
RRAY_DEVICE V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
RRAY_DEVICE V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
RRAY_DEVICE V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
RRAY_DEVICE float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RRAY_DEVICE V3 normalize(V3 a) {
  return scale(a, rsqrtf(fmaxf(dot(a, a), 1e-18f)));
}
RRAY_DEVICE V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }

}  // namespace rray
