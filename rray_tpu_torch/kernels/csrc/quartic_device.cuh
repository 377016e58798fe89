// The torus's quartic solver for the whitted kernel (stage e): Ferrari
// with the resolvent cubic and a 3-step Newton polish, a transcript of
// rray_tpu_torch/ops/quartic.py (rray_tpu ops/quartic.py:93-211 in the
// form its XLA path runs) in the same operation order.
//
// acos, cos and cbrt are evaluated in double and rounded to float, as the
// plain version evaluates them (quartic.f64_round): the float32 quartic
// is ill-conditioned, so two libraries' ulps in acosf or cbrtf would move
// a root by up to 1e-3 and flip texels and silhouettes; a rounded double
// is the same float from CUDA's libm, the host's and PyTorch's. Max, min
// and clamp propagate NaN as torch.clamp and jnp.maximum do (fmaxf does
// not).
//
// Like vec_device.cuh, the header also compiles as host C++
// (tests/test_torch_whitted_cuh.py); it needs RRAY_DEVICE and
// RRAY_NOINLINE defined.
#pragma once

#include "vec_device.cuh"

namespace rray {

constexpr float Q_TINY = 1e-12f;

RRAY_DEVICE float maxp(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
RRAY_DEVICE float minp(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
RRAY_DEVICE float clampp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
// torch.sign: -1, 0 or 1, NaN for NaN.
RRAY_DEVICE float signp(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
RRAY_DEVICE float safe_div(float a, float b) {
  const float denom = fabsf(b) < Q_TINY ? (b < 0.0f ? -Q_TINY : Q_TINY) : b;
  return a / denom;
}
RRAY_DEVICE float acos_r(float x) { return (float)acos((double)x); }
RRAY_DEVICE float cos_r(float x) { return (float)cos((double)x); }
RRAY_DEVICE float atan2_r(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
// sign(x) |x|^(1/3) in double, rounded (quartic._cbrt).
RRAY_DEVICE float cbrt_r(float x) {
  const double v = (double)x;
  const double s = v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : v);
  return (float)(s * pow(fabs(v), 1.0 / 3.0));
}

// Largest real root of y^3 + b y^2 + c y + d = 0.
RRAY_DEVICE float largest_real_cubic_root(float b, float c, float d) {
  const float shift = b / 3.0f;
  const float p = c - b * b / 3.0f;
  const float q = 2.0f * b * b * b / 27.0f - b * c / 3.0f + d;
  const float disc = 4.0f * p * p * p + 27.0f * q * q;
  // The plain version evaluates both forms and selects one; only the
  // selected one runs here (the same value: neither has side effects),
  // which skips a double acos and cos, or two double pows.
  if (disc <= 0.0f) {  // three real roots
    const float p_neg = minp(p, -Q_TINY);
    const float m = 2.0f * sqrtf(-p_neg / 3.0f);
    const float arg = clampp(3.0f * q / (p_neg * m), -1.0f, 1.0f);
    const float theta = acos_r(arg) / 3.0f;
    return m * cos_r(theta) - shift;
  }
  const float disc_pos = maxp(disc / 108.0f, 0.0f);
  const float sq = sqrtf(disc_pos);
  const float u3 = -q / 2.0f + sq;
  const float v3 = -q / 2.0f - sq;
  return (cbrt_r(u3) + cbrt_r(v3)) - shift;
}

// Roots of x^2 + b x + c with a validity flag (stable pairing).
RRAY_DEVICE void quadratic(float b, float c, float* r1, float* r2, bool* ok) {
  const float disc = b * b - 4.0f * c;
  *ok = disc >= 0.0f;
  const float s = sqrtf(maxp(disc, 0.0f));
  const float qq = -0.5f * (b + signp(b) * s);
  const bool small = fabsf(b) < Q_TINY;
  *r1 = small ? -0.5f * s : qq;
  *r2 = small ? 0.5f * s : safe_div(c, qq);
}

// The four roots of a quartic, and a bit per valid root.
struct Roots4 {
  float r[4];
  unsigned valid;
};

// All real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 = 0 (invalid
// slots hold junk). Not inlined: a stage-e kernel reaches it from several
// places, and each inlined copy of the double acos, cos and pow costs
// nvcc seconds; it takes and returns values only, so a call passes no
// address of the caller's state.
static RRAY_NOINLINE Roots4 solve_quartic(float c4, float c3, float c2,
                                          float c1, float c0) {
  float roots[4];
  bool valids[4];
  const float inv4 = safe_div(1.0f, c4);
  const float b = c3 * inv4, c = c2 * inv4, d = c1 * inv4, e = c0 * inv4;
  const float b2 = b * b;
  const float p = c - 3.0f * b2 / 8.0f;
  const float q = d - b * c / 2.0f + b2 * b / 8.0f;
  const float r = e - b * d / 4.0f + b2 * c / 16.0f - 3.0f * b2 * b2 / 256.0f;
  float y = largest_real_cubic_root(2.0f * p, p * p - 4.0f * r, -q * q);
  y = maxp(y, 0.0f);
  const float s = sqrtf(y);
  const bool biquad = s < 1e-6f;
  const float half = (p + y) / 2.0f;
  const float qs = safe_div(q, 2.0f * s);
  const float t1 = half - qs, t2 = half + qs;
  float r1a, r1b, r2a, r2b, z1, z2;
  bool ok1, ok2, okz;
  quadratic(s, biquad ? 0.0f : t1, &r1a, &r1b, &ok1);
  quadratic(-s, biquad ? 0.0f : t2, &r2a, &r2b, &ok2);
  quadratic(p, r, &z1, &z2, &okz);
  const bool bq1ok = okz && (z1 >= 0.0f), bq2ok = okz && (z2 >= 0.0f);
  const float sz1 = sqrtf(maxp(z1, 0.0f)), sz2 = sqrtf(maxp(z2, 0.0f));
  const float shift = b / 4.0f;
  roots[0] = (biquad ? sz1 : r1a) - shift;
  roots[1] = (biquad ? -sz1 : r1b) - shift;
  roots[2] = (biquad ? sz2 : r2a) - shift;
  roots[3] = (biquad ? -sz2 : r2b) - shift;
  valids[0] = valids[1] = biquad ? bq1ok : ok1;
  valids[2] = valids[3] = biquad ? bq2ok : ok2;
  Roots4 out;
  out.valid = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = roots[i];
    for (int it = 0; it < 3; ++it) {
      const float f = (((c4 * x + c3) * x + c2) * x + c1) * x + c0;
      const float df = ((4.0f * c4 * x + 3.0f * c3) * x + 2.0f * c2) * x + c1;
      const float step = clampp(safe_div(f, df), -1.0f, 1.0f);
      x = x - (valids[i] ? step : 0.0f);
    }
    out.r[i] = x;
    out.valid |= valids[i] ? 1u << i : 0u;
  }
  return out;
}

// Hit slots of the torus (major radius 1 in the xy plane, minor radius
// `minor_r`) on the object-space ray: the four quartic roots with t > 0,
// for a ray that enters the torus's box padded by 1e-3 (x, y in
// [-(1 + r), 1 + r], z in [-r, r]; rray_tpu soa.py:169-221). The slab
// test is per thread: a ray that misses the box solves nothing.
RRAY_DEVICE int torus_slots(V3 o, V3 d, float minor_r, float* t, bool* ok) {
  const float pad = 1e-3f;
  const float rx = 1.0f + minor_r + pad;
  const float rz = minor_r + pad;
  const float c[3] = {d.x, d.y, d.z};
  float iv[3];
  for (int k = 0; k < 3; ++k)
    iv[k] = 1.0f / (fabsf(c[k]) < 1e-30f ? (c[k] < 0.0f ? -1e-30f : 1e-30f)
                                         : c[k]);
  const float tx1 = (-rx - o.x) * iv[0], tx2 = (rx - o.x) * iv[0];
  const float ty1 = (-rx - o.y) * iv[1], ty2 = (rx - o.y) * iv[1];
  const float tz1 = (-rz - o.z) * iv[2], tz2 = (rz - o.z) * iv[2];
  const float tmin = maxp(maxp(minp(tx1, tx2), minp(ty1, ty2)), minp(tz1, tz2));
  const float tmax = minp(minp(maxp(tx1, tx2), maxp(ty1, ty2)), maxp(tz1, tz2));
  for (int k = 0; k < 4; ++k) {
    t[k] = 0.0f;
    ok[k] = false;
  }
  if (!((tmin <= tmax) && (tmax >= 0.0f))) return 4;
  const float r_sq = minor_r * minor_r;
  const float sum_d_sq = dot(d, d);
  const float e = dot(o, o) - r_sq + 1.0f;
  const float f = dot(o, d);
  const float a4 = sum_d_sq * sum_d_sq;
  const float a3 = 4.0f * sum_d_sq * f;
  const float a2 = 2.0f * sum_d_sq * e + 4.0f * f * f - 4.0f * (d.x * d.x + d.y * d.y);
  const float a1 = 4.0f * e * f - 8.0f * (o.x * d.x + o.y * d.y);
  const float a0 = e * e - 4.0f * (o.x * o.x + o.y * o.y);
  const Roots4 q = solve_quartic(a4, a3, a2, a1, a0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t[k] = q.r[k];
    ok[k] = ((q.valid >> k) & 1u) && (t[k] > 0.0f);
  }
  return 4;
}

}  // namespace rray
