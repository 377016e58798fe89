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
#ifndef __CUDACC__
#include <string.h>
#endif

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

// Four floats from a 16-byte-aligned address: one 16-byte load on the card.
struct F4 { float x, y, z, w; };
RRAY_DEVICE F4 ld4(const float* p) {
#ifdef __CUDACC__
  const float4 v = *reinterpret_cast<const float4*>(p);
  F4 r = {v.x, v.y, v.z, v.w};
#else
  F4 r = {p[0], p[1], p[2], p[3]};
#endif
  return r;
}

// The int32 whose bits a table float carries.
RRAY_DEVICE int bits_int(float f) {
#ifdef __CUDACC__
  return __float_as_int(f);
#else
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
#endif
}

// Index of the highest and of the lowest set bit of x > 0; set bits.
RRAY_DEVICE int top_bit(unsigned x) {
#ifdef __CUDACC__
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}
RRAY_DEVICE int low_bit(unsigned x) {
#ifdef __CUDACC__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}
RRAY_DEVICE int bit_count(unsigned x) {
#ifdef __CUDACC__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

}  // namespace rray
