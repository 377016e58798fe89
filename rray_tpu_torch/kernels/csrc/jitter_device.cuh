// The point-keyed jitter hash of the area-light kernels (rray_tpu
// ops/jitter.py; plain version rray_tpu_torch/ops/jitter.py), on
// uint32_t: wrapping products, logical shifts, so every draw is the
// plain version's bit for bit.
//
//   base = fmix32(bits(x) * C1 ^ fmix32(bits(y) * C2 ^ fmix32(bits(z)
//          * C3 ^ seed)))
//   draw(base, k) = (fmix32(base ^ k * 0x9E3779B9) >> 8) * 2^-24
//
// Like vec_device.cuh, the header also compiles as host C++
// (tests/test_torch_whitted_cuh.py).
#pragma once

#include <stdint.h>
#include <string.h>

namespace rray {

RRAY_DEVICE uint32_t float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
  return u;
#endif
}

// murmur3's finalizer.
RRAY_DEVICE uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Hash base of a shadow origin from its float32 bits and an int32 seed.
RRAY_DEVICE uint32_t point_base(int seed, float x, float y, float z) {
  uint32_t h = fmix32(float_bits(z) * 0x85EBCA6Bu ^ (uint32_t)seed);
  h = fmix32(float_bits(y) * 0x1B873593u ^ h);
  return fmix32(float_bits(x) * 0xCC9E2D51u ^ h);
}

// counter-th uniform in [0, 1): 24 bits, exact in float32.
RRAY_DEVICE float draw_unit(uint32_t base, uint32_t counter) {
  uint32_t h = fmix32(base ^ (counter * 0x9E3779B9u));
  return (float)(h >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

}  // namespace rray
