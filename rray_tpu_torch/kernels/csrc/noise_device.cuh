// FastNoiseLite Perlin noise and its fBm for the whitted kernel's noise
// and perturbed patterns (stage e): a transcript of
// rray_tpu_torch/ops/noise.py (rray_tpu ops/noise.py), bit for bit.
//
// The hash is int32 arithmetic with wrapping products: the products run
// on uint32_t (signed overflow is undefined in C++) and are read back as
// int32; `h >> 15` is the arithmetic shift of the int32 value, as JAX
// shifts it; the 64-entry gradient table is the closed-form select of
// rray_tpu noise.py:39-63; floors convert to int32 saturating, NaN to 0,
// as XLA converts them.
//
// Like vec_device.cuh, the header also compiles as host C++
// (tests/test_torch_whitted_cuh.py).
#pragma once

#include <stdint.h>

#include "vec_device.cuh"

namespace rray {

constexpr uint32_t PRIME_X = 501125321u;
constexpr uint32_t PRIME_Y = 1136930381u;
constexpr uint32_t PRIME_Z = 1720413743u;
constexpr uint32_t HASH_MUL = 668265261u;  // 0x27d4eb2d
constexpr int32_t NOISE_SEED = 1337;
constexpr float NOISE_FREQUENCY = 0.01f;
constexpr float PERLIN_SCALE = 0.964921414852142333984375f;

RRAY_DEVICE int32_t f2i_sat(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f < -2147483648.0f) return -2147483647 - 1;
  return (int32_t)f;
}

RRAY_DEVICE int32_t wrap_mul(int32_t a, uint32_t b) {
  return (int32_t)((uint32_t)a * b);
}

RRAY_DEVICE float grad_coord(int32_t xp, int32_t yp, int32_t zp, float xd,
                             float yd, float zd) {
  int32_t h = wrap_mul((NOISE_SEED ^ xp) ^ (yp ^ zp), HASH_MUL);
  h = h ^ (h >> 15);
  const int idx = (h & (63 << 2)) >> 2;
  if (idx >= 60)
    return idx == 60 ? xd + yd
                     : (idx == 61 ? zd - yd : (idx == 62 ? yd - xd : -yd - zd));
  const int j = idx % 12;
  const int k = j % 4;
  const float s1 = (k & 1) == 0 ? 1.0f : -1.0f;
  const float s2 = (k & 2) == 0 ? 1.0f : -1.0f;
  const int g = j >> 2;  // 0: x = 0, 1: y = 0, 2: z = 0
  return g == 0 ? s1 * yd + s2 * zd
                : (g == 1 ? s1 * xd + s2 * zd : s1 * xd + s2 * yd);
}

RRAY_DEVICE float quintic(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

RRAY_DEVICE float lerp_f(float a, float b, float t) { return a + t * (b - a); }

// Raw Perlin at already frequency-scaled coordinates.
RRAY_DEVICE float single_perlin3(float x, float y, float z) {
  const float xf = floorf(x), yf = floorf(y), zf = floorf(z);
  const float xd0 = x - xf, yd0 = y - yf, zd0 = z - zf;
  const float xd1 = xd0 - 1.0f, yd1 = yd0 - 1.0f, zd1 = zd0 - 1.0f;
  const float xs = quintic(xd0), ys = quintic(yd0), zs = quintic(zd0);
  const int32_t x0 = wrap_mul(f2i_sat(xf), PRIME_X);
  const int32_t y0 = wrap_mul(f2i_sat(yf), PRIME_Y);
  const int32_t z0 = wrap_mul(f2i_sat(zf), PRIME_Z);
  const int32_t x1 = (int32_t)((uint32_t)x0 + PRIME_X);
  const int32_t y1 = (int32_t)((uint32_t)y0 + PRIME_Y);
  const int32_t z1 = (int32_t)((uint32_t)z0 + PRIME_Z);
  const float xf00 = lerp_f(grad_coord(x0, y0, z0, xd0, yd0, zd0),
                            grad_coord(x1, y0, z0, xd1, yd0, zd0), xs);
  const float xf10 = lerp_f(grad_coord(x0, y1, z0, xd0, yd1, zd0),
                            grad_coord(x1, y1, z0, xd1, yd1, zd0), xs);
  const float xf01 = lerp_f(grad_coord(x0, y0, z1, xd0, yd0, zd1),
                            grad_coord(x1, y0, z1, xd1, yd0, zd1), xs);
  const float xf11 = lerp_f(grad_coord(x0, y1, z1, xd0, yd1, zd1),
                            grad_coord(x1, y1, z1, xd1, yd1, zd1), xs);
  const float yf0 = lerp_f(xf00, xf10, ys);
  const float yf1 = lerp_f(xf01, xf11, ys);
  return lerp_f(yf0, yf1, zs) * PERLIN_SCALE;
}

// fBm normalized by the total amplitude (noise.rs:50-63). Inlined: the
// whitted kernel's pattern program calls it from two places.
RRAY_DEVICE float octave_perlin(float x, float y, float z, int octaves,
                                float persistence) {
  float total = 0.0f, frequency = 1.0f, amplitude = 1.0f, max_value = 0.0f;
  for (int o = 0; o < octaves; ++o) {
    const float n = single_perlin3(x * frequency * NOISE_FREQUENCY,
                                   y * frequency * NOISE_FREQUENCY,
                                   z * frequency * NOISE_FREQUENCY);
    total = total + n * amplitude;
    max_value = max_value + amplitude;
    amplitude = amplitude * persistence;
    frequency = frequency * 2.0f;
  }
  return max_value == 0.0f ? total : total / max_value;
}

}  // namespace rray
