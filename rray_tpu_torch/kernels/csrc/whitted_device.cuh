// Per-ray device code of the compact Whitted kernel (see whitted.cu).
//
// One call of trace_ray<W, kExt, KB> evaluates one primary ray's whole
// Whitted tree: W path rows per level, 2W children, stable top-W by
// weight. The arithmetic is a transcript of
// rray_tpu/kernels/whitted.py::_node_row and _kernel, written in the same
// operation order as the plain PyTorch version
// (rray_tpu_torch/kernels/whitted.py). Built with --fmad=false, every
// product and sum rounds where the plain version's does, so the two agree
// bit for bit except where rsqrtf/powf differ by an ulp. kExt compiles in
// stage e (tori, CSG, noise, perturbed and image patterns); scenes
// without it run the kExt = false instantiation, which holds none of it.
// KB is the compile-time bucket of the CSG member slots (8: in registers;
// 80: the general form; 0: no CSG).
//
// Nothing here takes the address of a per-thread aggregate across a call:
// the scene is a pointer to the kernel's __grid_constant__ descriptor
// (offsets and counts) and a pointer to the staged tables, every function
// is inlined but the torus quartic (values in, values out), pattern trees
// run as flat programs in one loop, and fixed-size slot arrays are indexed
// by unrolled constants, so ptxas keeps the per-ray state in registers.
//
// Like vec_device.cuh and mesh_device.cuh, the header also compiles as
// host C++ (tests/test_torch_whitted_cuh.py).
#pragma once

#include "jitter_device.cuh"
#include "mesh_device.cuh"
#include "noise_device.cuh"
#include "quartic_device.cuh"

namespace rray {

constexpr int P_COLS = 32;    // prim row: see kernels/whitted.py P_COLS
constexpr int PAT_COLS = 17;  // pattern node row
constexpr int L_COLS = 15;    // light row
constexpr int T_COLS = 19;    // mesh row: p1 e1 e2 n1 n2 n3, group id
constexpr int A_COLS = 16;    // occluder row: affine 0-11, extras 12-14
constexpr int MESH_CHUNK = 24;
constexpr int MAX_PATTERN_DEPTH = 8;
constexpr int MAX_FRAMES = MAX_PATTERN_DEPTH - 1;  // pattern stack frames
constexpr int FRAME_WORDS = 6;                     // point, then colour
constexpr float EPS_OFF = 1e-3f;  // f32 over/under offset
constexpr float TOL = 1e-4f;      // f32 n1/n2 hit-match tolerance
constexpr int MAX_SLOTS = 5;      // hit slots of one prim (cone)
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

enum Kind { SPHERE = 0, PLANE = 1, CUBE = 2, CYLINDER = 3, CONE = 4,
            TORUS = 5 };
// Pattern program ops: a node's PType code enters it; the rest are
// control ops (kernels/whitted.py pattern_program emits them).
enum PType { SOLID = 0, STRIPE = 1, GRADIENT = 2, RING = 3, CHECKER = 4,
             BLEND = 5, NOISE = 6, PERTURBED = 7, IMAGE = 8, OP_JUMP = 9,
             OP_MID = 10, OP_COMBINE = 11, OP_POPSCALE = 12, OP_END = 13 };
enum CsgOp { CSG_UNION = 0, CSG_INTERSECTION = 1, CSG_DIFFERENCE = 2 };

// Scene descriptor words, in kernels/whitted.py DESC_FIELDS order: word
// offsets of the tables in the staged block, then counts and flags.
enum Desc {
  D_PRIMS, D_PATS, D_LIGHTS, D_KINDS, D_ROOTS, D_PROG, D_LEVELS, D_SEEDS,
  D_PMETA, D_MEMBER, D_CSG_OPS, D_CSG_SIDE, D_TRIS, D_TBOXES,
  D_P, D_L, D_T, D_CHUNKS, D_C, D_DEPTH, D_REFL, D_REFR, D_WIDTH, D_R,
  D_WORDS, D_COUNT
};

// What the kernel takes as its __grid_constant__ parameter: uniform over
// the launch, read from the constant bank where it is used.
struct SceneDesc {
  int w[D_COUNT];
  const float* texels;  // flat texel table (global memory), or null
};

// The scene as the per-ray code sees it: the descriptor and the staged
// tables (shared memory on the card; float rows, then int tables).
// Tables: prims [P + G, P_COLS] (analytic prims, then mesh groups), pats
// [N, PAT_COLS], lights [L, L_COLS]; kinds [P], roots [P + G] (program
// start of each prim row's pattern), prog [n, 4] (op, row, target, aux),
// levels [L] (0: point light), seeds [depth + 1, L]; stage e: pmeta [N, 4]
// (noise/perturbed: octaves; image: H, W, texel offset, format), member
// [P], csg_ops [C], csg_side [C, P] (0 not under the CSG, 1 left, 2
// right), innermost CSG first; the mesh: tris [T, T_COLS], tboxes [6,
// n_chunks + 1].
struct Scene {
  const SceneDesc* d;
  const float* w;

  RRAY_DEVICE int at(int k) const { return d->w[k]; }
  RRAY_DEVICE const int* ints(int table) const {
    return reinterpret_cast<const int*>(w) + d->w[table];
  }
  RRAY_DEVICE int P() const { return d->w[D_P]; }
  RRAY_DEVICE int L() const { return d->w[D_L]; }
  RRAY_DEVICE int T() const { return d->w[D_T]; }
  RRAY_DEVICE int C() const { return d->w[D_C]; }
  RRAY_DEVICE const float* prim(int i) const {
    return w + d->w[D_PRIMS] + i * P_COLS;
  }
  RRAY_DEVICE const float* pat(int row) const {
    return w + d->w[D_PATS] + row * PAT_COLS;
  }
  RRAY_DEVICE const float* light(int li) const {
    return w + d->w[D_LIGHTS] + li * L_COLS;
  }
  RRAY_DEVICE int kind(int i) const { return ints(D_KINDS)[i]; }
  RRAY_DEVICE int root(int i) const { return ints(D_ROOTS)[i]; }
  RRAY_DEVICE const int* ins(int pc) const { return ints(D_PROG) + 4 * pc; }
  RRAY_DEVICE int level(int li) const { return ints(D_LEVELS)[li]; }
  RRAY_DEVICE int seed(int lvl, int li) const {
    return ints(D_SEEDS)[lvl * L() + li];
  }
  RRAY_DEVICE const int* pmeta(int row) const {
    return ints(D_PMETA) + 4 * row;
  }
  RRAY_DEVICE bool member(int i) const { return ints(D_MEMBER)[i] != 0; }
  RRAY_DEVICE int csg_op(int ci) const { return ints(D_CSG_OPS)[ci]; }
  RRAY_DEVICE const int* csg_side(int ci) const {
    return ints(D_CSG_SIDE) + ci * P();
  }
  RRAY_DEVICE const float* tris() const { return w + d->w[D_TRIS]; }
  RRAY_DEVICE const float* tboxes() const { return w + d->w[D_TBOXES]; }
};

// A thread's pattern stack: frame f's word c at p[(f * FRAME_WORDS + c) *
// stride] (on the card a per-thread column of shared memory, stride the
// block size, so a warp's accesses hit 32 banks).
struct Stack {
  float* p;
  int stride;
  RRAY_DEVICE float& at(int f, int c) const {
    return p[(f * FRAME_WORDS + c) * stride];
  }
};

RRAY_DEVICE V3 affine_pt(const float* p, V3 v) {
  return v3(p[0] * v.x + p[1] * v.y + p[2] * v.z + p[3],
            p[4] * v.x + p[5] * v.y + p[6] * v.z + p[7],
            p[8] * v.x + p[9] * v.y + p[10] * v.z + p[11]);
}
RRAY_DEVICE V3 affine_vec(const float* p, V3 v) {
  return v3(p[0] * v.x + p[1] * v.y + p[2] * v.z,
            p[4] * v.x + p[5] * v.y + p[6] * v.z,
            p[8] * v.x + p[9] * v.y + p[10] * v.z);
}
RRAY_DEVICE V3 nmat_vec(const float* p, V3 v) {
  return v3(p[12] * v.x + p[13] * v.y + p[14] * v.z,
            p[15] * v.x + p[16] * v.y + p[17] * v.z,
            p[18] * v.x + p[19] * v.y + p[20] * v.z);
}

// ---- hit slots (rray_tpu ops/soa.py forms, quirks included) -------------
// Each form fills its first n slots; callers clear all MAX_SLOTS first and
// loop over all of them, so the arrays are indexed by constants.

RRAY_DEVICE int sphere_slots(V3 o, V3 d, float* t, bool* ok) {
  float a = dot(d, d);
  float b = 2.0f * dot(d, o);
  float c = dot(o, o) - 1.0f;
  float disc = b * b - 4.0f * a * c;
  bool hit = disc >= 0.0f;
  float sq = sqrtf(fmaxf(disc, 1e-30f));
  float inv2a = 0.5f / a;
  t[0] = (-b - sq) * inv2a;
  t[1] = (-b + sq) * inv2a;
  ok[0] = ok[1] = hit;
  return 2;
}

RRAY_DEVICE int plane_slots(V3 o, V3 d, float* t, bool* ok) {
  ok[0] = fabsf(d.y) >= EPSILON;
  t[0] = -o.y / (ok[0] ? d.y : 1.0f);
  return 1;
}

RRAY_DEVICE void cube_axis(float oc, float dc, float* lo, float* hi) {
  bool parallel = fabsf(dc) < EPSILON;
  float dsafe = parallel ? 1.0f : dc;
  float t1 = (-1.0f - oc) / dsafe;
  float t2 = (1.0f - oc) / dsafe;
  *lo = fminf(t1, t2);
  *hi = fmaxf(t1, t2);
  if (parallel) {
    bool inside = (oc >= -1.0f) && (oc <= 1.0f);
    *lo = inside ? -1e30f : 1e30f;
    *hi = inside ? 1e30f : -1e30f;
  }
}

RRAY_DEVICE int cube_slots(V3 o, V3 d, float* t, bool* ok) {
  float xlo, xhi, ylo, yhi, zlo, zhi;
  cube_axis(o.x, d.x, &xlo, &xhi);
  cube_axis(o.y, d.y, &ylo, &yhi);
  cube_axis(o.z, d.z, &zlo, &zhi);
  t[0] = fmaxf(xlo, fmaxf(ylo, zlo));
  t[1] = fminf(xhi, fminf(yhi, zhi));
  ok[0] = ok[1] = t[0] <= t[1];
  return 2;
}

RRAY_DEVICE void cap_slots(V3 o, V3 d, float ymin, float ymax,
                                  bool closed, bool cone, float* t, bool* ok) {
  bool steep = fabsf(d.y) >= EPSILON;
  bool cap_possible = steep && closed;
  float dsafe = steep ? d.y : 1.0f;
  float bounds[2] = {ymin, ymax};
  for (int k = 0; k < 2; ++k) {
    float tk = (bounds[k] - o.y) / dsafe;
    float x = o.x + tk * d.x;
    float z = o.z + tk * d.z;
    float radius = 1.0f;
    if (cone) {
      float y = o.y + tk * d.y;
      radius = y * y;
    }
    t[k] = tk;
    ok[k] = cap_possible && (x * x + z * z <= radius);
  }
}

// `ex` points at a prim's ymin, ymax, closed (prim rows: p + 21; the
// area-shadow kernel's 16-column rows: p + 12).
RRAY_DEVICE int cylinder_slots(V3 o, V3 d, const float* ex, float* t,
                                      bool* ok) {
  float ymin = ex[0], ymax = ex[1];
  bool closed = ex[2] != 0.0f;
  float a = d.x * d.x + d.z * d.z;
  bool body_possible = fabsf(a) > EPSILON;
  float b = 2.0f * (o.x * d.x + o.z * d.z);
  float c = o.x * o.x + o.z * o.z - 1.0f;
  float disc = b * b - 4.0f * a * c;
  bool hit = body_possible && (disc >= 0.0f);
  float sq = sqrtf(fmaxf(disc, 1e-30f));
  float inv2a = 0.5f / (body_possible ? a : 1.0f);
  float lo = (-b - sq) * inv2a;
  float hi = (-b + sq) * inv2a;
  float l2 = fminf(lo, hi), h2 = fmaxf(lo, hi);
  float y0 = o.y + l2 * d.y;
  float y1 = o.y + h2 * d.y;
  t[0] = l2;
  ok[0] = hit && (ymin < y0) && (y0 < ymax);
  t[1] = h2;
  ok[1] = hit && (ymin < y1) && (y1 < ymax);
  // A negative discriminant drops the caps too (cylinder.rs:101-102).
  bool miss_all = body_possible && (disc < 0.0f);
  cap_slots(o, d, ymin, ymax, closed, false, t + 2, ok + 2);
  ok[2] = ok[2] && !miss_all;
  ok[3] = ok[3] && !miss_all;
  return 4;
}

RRAY_DEVICE int cone_slots(V3 o, V3 d, const float* ex, float* t,
                                  bool* ok) {
  float ymin = ex[0], ymax = ex[1];
  bool closed = ex[2] != 0.0f;
  float a = d.x * d.x - d.y * d.y + d.z * d.z;
  float b = 2.0f * (o.x * d.x - o.y * d.y + o.z * d.z);
  float c = o.x * o.x - o.y * o.y + o.z * o.z;
  bool a_small = fabsf(a) < EPSILON;
  bool b_small = fabsf(b) < EPSILON;
  float t_lin = -c / (b_small ? 1.0f : 2.0f * b);
  float y_lin = o.y + t_lin * d.y;
  bool lin_hit = a_small && !b_small && (ymin < y_lin) && (y_lin < ymax);
  float disc = b * b - 4.0f * a * c;
  bool quad_path = !(a_small && b_small) && !lin_hit;
  bool okq = quad_path && (disc >= 0.0f);
  float sq = sqrtf(fmaxf(disc, 1e-30f));
  float inv2a = 0.5f / (a_small ? (a < 0.0f ? -EPSILON : EPSILON) : a);
  float lo = (-b - sq) * inv2a;
  float hi = (-b + sq) * inv2a;
  float l2 = fminf(lo, hi), h2 = fmaxf(lo, hi);
  float y0 = o.y + l2 * d.y;
  float y1 = o.y + h2 * d.y;
  t[0] = t_lin;
  ok[0] = lin_hit;
  t[1] = l2;
  ok[1] = okq && (ymin < y0) && (y0 < ymax);
  t[2] = h2;
  ok[2] = okq && (ymin < y1) && (y1 < ymax);
  bool miss_all = quad_path && (disc < 0.0f);
  cap_slots(o, d, ymin, ymax, closed, true, t + 3, ok + 3);
  ok[3] = ok[3] && !lin_hit && !miss_all;
  ok[4] = ok[4] && !lin_hit && !miss_all;
  return 5;
}

// Hit slots of a prim of kind k (extras at ex) on the object-space ray:
// returns the kind's count, and all MAX_SLOTS are set, those past the
// count cleared.
RRAY_DEVICE int prim_slots(int k, const float* ex, V3 o, V3 d, float* t,
                           bool* ok) {
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) {
    t[s] = 0.0f;
    ok[s] = false;
  }
  switch (k) {
    case SPHERE: return sphere_slots(o, d, t, ok);
    case PLANE: return plane_slots(o, d, t, ok);
    case CUBE: return cube_slots(o, d, t, ok);
    case CYLINDER: return cylinder_slots(o, d, ex, t, ok);
    default: return cone_slots(o, d, ex, t, ok);
  }
}

// ---- shadow predicate (rray_tpu kernels/analytic.py _occludes) ----------

// c = dot(o, o) - 1, a term of the origin alone (area_count computes it
// once per origin and prim).
RRAY_DEVICE bool sphere_occludes(V3 o, V3 d, float c, float dist) {
  float a = dot(d, d);
  float b = 2.0f * dot(d, o);
  bool real = b * b - 4.0f * a * c >= 0.0f;
  float fd = (a * dist + b) * dist + c;
  float s2 = b + 2.0f * a * dist;
  bool tm_in = (b <= 0.0f) && (c >= 0.0f) && ((s2 > 0.0f) || (fd < 0.0f));
  bool tp_in = ((b <= 0.0f) || (c <= 0.0f)) && (s2 > 0.0f) && (fd > 0.0f);
  return real && (tm_in || tp_in);
}

RRAY_DEVICE bool plane_occludes(V3 o, V3 d, float dist) {
  float oy_dy = o.y * d.y;
  return (fabsf(d.y) >= EPSILON) && (oy_dy <= 0.0f) &&
         (-oy_dy < dist * d.y * d.y);
}

// Does a prim of kind k (extras at ex) block [0, dist) on the
// object-space shadow ray (o, d)? c: dot(o, o) - 1 (sphere_occludes).
RRAY_DEVICE bool occludes_local(int k, const float* ex, V3 o, float c, V3 d,
                                float dist) {
  if (k == SPHERE) return sphere_occludes(o, d, c, dist);
  if (k == PLANE) return plane_occludes(o, d, dist);
  float t[MAX_SLOTS];
  bool ok[MAX_SLOTS];
  prim_slots(k, ex, o, d, t, ok);
  bool hit = false;
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s)
    hit = hit || (ok[s] && t[s] >= 0.0f && t[s] < dist);
  return hit;
}

// Does prim p (world->object affine at p[0..11], extras at ex) block
// [0, dist) on the world-space shadow ray?
RRAY_DEVICE bool occludes(int k, const float* p, const float* ex, V3 over,
                                 V3 dir, float dist) {
  V3 o = affine_pt(p, over);
  return occludes_local(k, ex, o, dot(o, o) - 1.0f, affine_vec(p, dir), dist);
}

// Sample k of an area light's lv x lv jittered grid (light.rs:47-65;
// rray_tpu whitted.py:1149-1163): the segment from `over` to the sample
// as a unit direction, and its length. cuv holds corner, uvec, vvec.
RRAY_DEVICE float area_sample(const float* cuv, uint32_t hb, int k, int lv,
                              V3 over, V3* dir) {
  float ur = ((float)(k % lv) + draw_unit(hb, 2u * k)) / (float)lv;
  float vr = ((float)(k / lv) + draw_unit(hb, 2u * k + 1u)) / (float)lv;
  float sx = cuv[0] + cuv[3] * ur + cuv[6] * vr - over.x;
  float sy = cuv[1] + cuv[4] * ur + cuv[7] * vr - over.y;
  float sz = cuv[2] + cuv[5] * ur + cuv[8] * vr - over.z;
  float dist = sqrtf(sx * sx + sy * sy + sz * sz);
  float inv = 1.0f / fmaxf(dist, 1e-30f);
  *dir = v3(sx * inv, sy * inv, sz * inv);
  return dist;
}

// Samples per chunk of the area-shadow kernel's body, and the floats a
// thread keeps per sample: its segment's unit direction and length.
constexpr int AREA_CHUNK = 16;
constexpr int SEG_WORDS = 4;
constexpr int B_COLS = 8;  // occluder bounds row: lo xyz, hi xyz, bounded

// The area-shadow kernel's per-origin body (area.cu): how many of the
// lv^2 samples of the light (cuv: corner, uvec, vvec) some prim blocks;
// prims are [P, A_COLS] rows of the given kinds. Prim-major: per chunk of
// AREA_CHUNK samples, the segments are drawn once into `seg` (sample k's
// four floats at seg + SEG_WORDS * k * stride: on the card a column of
// shared memory, stride the block size), then each prim (its object-space
// origin and sphere term computed once) is tested against the chunk's
// samples that are still open (a mask), until none is. The (sample,
// prim) pairs tested are those of the sample-major loop that stops a
// sample at its first occluder, less those a conservative cull drops, so
// the count is the same; on the card every lane of a warp stands on the
// same prim (one kind, one broadcast row). The cull: where `bounds`
// ([P, B_COLS] padded world boxes, kernels/analytic.py occluder_bounds)
// marks a prim bounded and its box misses the box of the origin and the
// light's parallelogram, which holds every segment, the prim is skipped.
RRAY_DEVICE float area_count(const float* cuv, const float* params,
                             const float* bounds, const int* kinds, int P,
                             int lv, int seed, V3 over, float* seg,
                             int stride) {
  const uint32_t hb = point_base(seed, over.x, over.y, over.z);
  const int n = lv * lv;
  float lo[3] = {over.x, over.y, over.z}, hi[3] = {over.x, over.y, over.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float c = cuv[a], u = cuv[3 + a], v = cuv[6 + a];
    const float q[4] = {c, c + u, c + v, c + u + v};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[a] = fminf(lo[a], q[k]);
      hi[a] = fmaxf(hi[a], q[k]);
    }
  }
  int cnt = 0;
  for (int s0 = 0; s0 < n; s0 += AREA_CHUNK) {
    const int m = n - s0 < AREA_CHUNK ? n - s0 : AREA_CHUNK;
    for (int k = 0; k < m; ++k) {
      V3 dir;
      float* w = seg + SEG_WORDS * k * stride;
      w[3] = area_sample(cuv, hb, s0 + k, lv, over, &dir);
      w[0] = dir.x;
      w[1] = dir.y;
      w[2] = dir.z;
    }
    const unsigned drawn = m == 32 ? ~0u : (1u << m) - 1u;
    unsigned open = drawn;
    for (int j = 0; j < P && open; ++j) {
      const float* b = bounds + j * B_COLS;
      if (b[6] != 0.0f && (b[0] > hi[0] || b[1] > hi[1] || b[2] > hi[2] ||
                           b[3] < lo[0] || b[4] < lo[1] || b[5] < lo[2]))
        continue;
      const float* p = params + j * A_COLS;
      const int kind = kinds[j];
      const V3 o = affine_pt(p, over);
      const float c = dot(o, o) - 1.0f;
      for (unsigned left = open; left; left &= left - 1u) {
        const int k = low_bit(left);
        const F4 w = ld4(seg + SEG_WORDS * k * stride);
        if (occludes_local(kind, p + 12, o, c,
                           affine_vec(p, v3(w.x, w.y, w.z)), w.w))
          open &= ~(1u << k);
      }
    }
    cnt += bit_count(drawn ^ open);
  }
  return (float)cnt;
}

// ---- normals and patterns -----------------------------------------------

RRAY_DEVICE V3 local_normal(int k, const float* p, V3 lp) {
  float x = lp.x, y = lp.y, z = lp.z;
  if (k == SPHERE) return lp;
  if (k == PLANE) return v3(0.0f, 1.0f, 0.0f);
  if (k == CUBE) {
    float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    float maxc = fmaxf(ax, fmaxf(ay, az));
    return v3(maxc == ax ? x : 0.0f,
              (maxc != ax && maxc == ay) ? y : 0.0f,
              (maxc != ax && maxc != ay) ? z : 0.0f);
  }
  float cmin = p[21], cmax = p[22];
  float dist = x * x + z * z;
  bool top = (dist < 1.0f) && (y >= cmax - EPSILON);
  bool bot = (dist < 1.0f) && (y <= cmin + EPSILON);
  float side_y = 0.0f;
  if (k == CONE) {
    float ny = sqrtf(fmaxf(dist, 0.0f));
    side_y = y > 0.0f ? -ny : ny;
  }
  bool cap = top || bot;
  return v3(cap ? 0.0f : x, top ? 1.0f : (bot ? -1.0f : side_y),
            cap ? 0.0f : z);
}

RRAY_DEVICE bool even(float v) { return fmodf(v, 2.0f) == 0.0f; }

// A stripe, ring or checker node at pattern-space point p: does it show
// child a?
RRAY_DEVICE bool select_a(int type, V3 p) {
  if (type == STRIPE) return even(floorf(p.x));
  if (type == RING) return even(floorf(sqrtf(p.x * p.x + p.z * p.z)));
  return even(floorf(p.x) + floorf(p.y) + floorf(p.z));  // CHECKER
}

// A gradient or blend node (row g, point p) of its children's colours.
RRAY_DEVICE V3 mix(int type, const float* g, V3 p, V3 a, V3 b) {
  if (type == GRADIENT) {
    float frac = p.x - floorf(p.x);
    return add(a, scale(sub(b, a), frac));
  }
  float sc = g[15];  // BLEND
  return add(scale(a, 1.0f - sc), scale(b, sc));
}

// ---- stage e: uv mappings, texels ------------------------------------------

RRAY_DEVICE int imin(int a, int b) { return a < b ? a : b; }

// Python's x % m for m > 0 (torch.remainder, jnp.mod).
RRAY_DEVICE float pymod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && r < 0.0f) r = r + m;
  return r;
}

// uv mapping of a prim of kind k (row pw) on pattern-space points: the
// plain version's _uv_kind (shade_soa.uv_at's formulas; atan2 and acos
// in double, rounded).
RRAY_DEVICE void uv_kind(int k, const float* pw, V3 q, float* u, float* v) {
  const float x = q.x, y = q.y, z = q.z;
  if (k == SPHERE) {
    const float theta = atan2_r(z, x);
    const float rr = sqrtf(maxp(x * x + y * y + z * z, 1e-30f));
    const float phi = acos_r(clampp(y / rr, -1.0f, 1.0f));
    *u = (theta + PI_F) / TWO_PI_F;
    *v = 1.0f - phi / PI_F;
  } else if (k == PLANE) {
    *u = pymod(x, 1.0f);
    *v = pymod(z, 1.0f);
  } else if (k == CUBE) {
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    const bool fx = (ax >= ay) && (ax >= az);
    const bool fy = !fx && (ay >= ax) && (ay >= az);
    const float ur = x > 0.0f ? (z + 1.0f) * 0.5f : (1.0f - z) * 0.5f;
    const float uy = (x + 1.0f) * 0.5f;
    const float vy = y > 0.0f ? (1.0f - z) * 0.5f : (z + 1.0f) * 0.5f;
    const float uz = z > 0.0f ? (x + 1.0f) * 0.5f : (1.0f - x) * 0.5f;
    *u = fx ? ur : (fy ? uy : uz);
    *v = fy ? vy : (y + 1.0f) * 0.5f;
  } else if (k == CYLINDER) {
    const float cmin = pw[21], cmax = pw[22];
    const bool cap = (pw[23] != 0.0f) && ((y <= cmin) || (y >= cmax));
    const float theta = atan2_r(z, x);
    *u = cap ? (x + 1.0f) / 2.0f : (theta + PI_F) / TWO_PI_F;
    *v = cap ? (z + 1.0f) / 2.0f : pymod(y, 1.0f);
  } else if (k == CONE) {
    const float cmin = pw[21], cmax = pw[22];
    const bool cap = (pw[23] != 0.0f) && ((fabsf(y - cmin) <= EPSILON) ||
                                          (fabsf(y - cmax) <= EPSILON));
    const float radius = maxp(fabsf(y), 1e-30f);
    const float theta = (atan2_r(z, x) + PI_F) / TWO_PI_F;
    float height = cmax - cmin;
    if (fabsf(height) < 1e-30f) height = 1e-30f;
    *u = cap ? (x / radius + 1.0f) / 2.0f : (y - cmin) / height;
    *v = cap ? (z / radius + 1.0f) / 2.0f : theta;
  } else {  // TORUS (torus.rs:150-161)
    *u = (atan2_r(y, x) + PI_F) / TWO_PI_F;
    const float dist = sqrtf(maxp(x * x + y * y, 1e-30f)) - 1.0f;
    *v = (atan2_r(z, dist) + PI_F) / TWO_PI_F;
  }
}

// The texel an image leaf (meta: H, W, table offset, format) shows at
// (u, v): clamp, scale, truncate, flip v (pattern.rs:209-213,
// texture.rs:32-54), then one read from the flat texel table.
RRAY_DEVICE V3 texel(const float* texels, const int* meta, float u, float v) {
  const int h = meta[0], w = meta[1];
  u = clampp(u, 0.0f, 1.0f);
  v = clampp(v, 0.0f, 1.0f);
  const int xi = imin(f2i_sat(u * (float)w), w - 1);
  const int yi = h - 1 - imin(f2i_sat(v * (float)h), h - 1);
  const int flat = yi * w + xi;
  if (meta[3] == 0) {  // packed RGB8, exact in float
    const int px = (int)texels[meta[2] + flat];
    const float k = (float)(1.0 / 255.0);
    return v3((float)((px >> 16) & 0xFF) * k, (float)((px >> 8) & 0xFF) * k,
              (float)(px & 0xFF) * k);
  }
  const float* t = texels + meta[2] + 3 * flat;
  return v3(t[0], t[1], t[2]);
}

// ---- pattern programs ------------------------------------------------------

// One pattern tree, flattened by the host into a program (kernels/
// whitted.py pattern_program), at pattern-space point `pts` from
// instruction `pc`; an image leaf maps its point to uv on the winner's
// shape (kind k, row pw). Ops, each on `q`, the input point of the node
// being entered, and `c`, the last colour:
//   SOLID, IMAGE (row)        leaf: c = its colour
//   STRIPE/RING/CHECKER (row, b)  q = p = the node's point; go on to
//                             child a's code, or to b when the node shows
//                             child b (the other child is skipped: it
//                             has no effect on the value)
//   NOISE (row, b)            the same, picking by the noise's sign, and
//                             pushes the factor that POPSCALE applies
//   PERTURBED (row)           q = p + the noise offsets; child a follows
//   GRADIENT/BLEND (row)      pushes p; child a follows; MID keeps c and
//                             restores q = p for child b; COMBINE (row,
//                             aux = type) pops and mixes
//   JUMP (target)             skips the branch not taken
//   END                       c is the tree's value
template <bool kExt>
RRAY_DEVICE V3 eval_program(const Scene& s, Stack stk, int pc, V3 q, int k,
                            const float* pw) {
  V3 c = v3(0.0f, 0.0f, 0.0f);
  int sp = 0;
  for (;;) {
    const int* ins = s.ins(pc);
    const int op = ins[0];
    if (op == OP_END) break;
    ++pc;
    if (op == SOLID) {
      const float* g = s.pat(ins[1]);
      c = v3(g[12], g[13], g[14]);
    } else if (op == STRIPE || op == RING || op == CHECKER) {
      q = affine_pt(s.pat(ins[1]), q);
      if (!select_a(op, q)) pc = ins[2];
    } else if (op == GRADIENT || op == BLEND) {
      q = affine_pt(s.pat(ins[1]), q);
      stk.at(sp, 0) = q.x;
      stk.at(sp, 1) = q.y;
      stk.at(sp, 2) = q.z;
      ++sp;
    } else if (op == OP_MID) {
      stk.at(sp - 1, 3) = c.x;
      stk.at(sp - 1, 4) = c.y;
      stk.at(sp - 1, 5) = c.z;
      q = v3(stk.at(sp - 1, 0), stk.at(sp - 1, 1), stk.at(sp - 1, 2));
    } else if (op == OP_COMBINE) {
      --sp;
      const V3 p = v3(stk.at(sp, 0), stk.at(sp, 1), stk.at(sp, 2));
      const V3 a = v3(stk.at(sp, 3), stk.at(sp, 4), stk.at(sp, 5));
      c = mix(ins[3], s.pat(ins[1]), p, a, c);
    } else if (op == OP_JUMP) {
      pc = ins[2];
    } else if (kExt) {
      const float* g = s.pat(ins[1]);
      if (op == IMAGE) {
        const V3 p = affine_pt(g, q);
        float u, v;
        uv_kind(k, pw, p, &u, &v);
        c = texel(s.d->texels, s.pmeta(ins[1]), u, v);
      } else if (op == PERTURBED) {
        const V3 p = affine_pt(g, q);
        const float sc = g[15], per = g[16];
        const int octaves = s.pmeta(ins[1])[0];
        const float nx = octave_perlin(p.x, p.y, p.z, octaves, per) * sc;
        const float ny = octave_perlin(p.x, p.y, p.z + 1.0f, octaves, per) * sc;
        const float nz = octave_perlin(p.x, p.y, p.z + 2.0f, octaves, per) * sc;
        q = v3(p.x + nx, p.y + ny, p.z + nz);
      } else if (op == NOISE) {
        q = affine_pt(g, q);
        const float n =
            octave_perlin(q.x, q.y, q.z, s.pmeta(ins[1])[0], g[16]) * g[15];
        const bool neg = n <= 0.0f;
        stk.at(sp, 0) = neg ? -n : n;
        ++sp;
        if (!neg) pc = ins[2];
      } else if (op == OP_POPSCALE) {
        --sp;
        c = scale(c, stk.at(sp, 0));
      }
    }
  }
  return c;
}

// ---- stage e: tori and CSG ------------------------------------------------

// Hit slots of prim i (row p) on the object-space ray, tori included
// under kExt: returns the kind's count; all MAX_SLOTS are set.
template <bool kExt>
RRAY_DEVICE int slots_of(int k, const float* p, V3 o, V3 d, float* t,
                         bool* ok) {
  if (kExt && k == TORUS) {
    t[4] = 0.0f;
    ok[4] = false;
    return torus_slots(o, d, p[31], t, ok);
  }
  return prim_slots(k, p + 21, o, d, t, ok);
}

template <bool kExt>
RRAY_DEVICE V3 local_normal_of(int k, const float* p, V3 lp) {
  if (kExt && k == TORUS) {
    const float r = p[31];
    const float ss = lp.x * lp.x + lp.y * lp.y + lp.z * lp.z;
    const float ps = 1.0f + r * r;
    return v3(4.0f * lp.x * (ss - ps), 4.0f * lp.y * (ss - ps),
              4.0f * lp.z * (ss - ps + 2.0f));
  }
  return local_normal(k, p, lp);
}

// Bit set over the member slots of one ray.
template <int KB>
struct SlotBits {
  uint64_t w[(KB + 63) / 64];
  RRAY_DEVICE bool get(int i) const { return (w[i >> 6] >> (i & 63)) & 1u; }
  RRAY_DEVICE void set(int i, bool b) {
    const uint64_t m = (uint64_t)1 << (i & 63);
    w[i >> 6] = b ? (w[i >> 6] | m) : (w[i >> 6] & ~m);
  }
  RRAY_DEVICE void clear() {
    for (int k = 0; k < (KB + 63) / 64; ++k) w[k] = 0;
  }
  RRAY_DEVICE bool any() const {
    uint64_t x = 0;
    for (int k = 0; k < (KB + 63) / 64; ++k) x |= w[k];
    return x != 0;
  }
};

// The CSG member slots of one ray, in static (prim, slot) order, K of at
// most KB. With KB <= 8 every loop over them is unrolled, so the arrays
// stay in registers; the 80-slot form indexes them at run time.
template <int KB>
struct MemberSlots {
  float t[KB];
  int pid[KB];
  SlotBits<KB> valid;
  int K;

  // Appends slot (t, prim i, valid) at position K.
  RRAY_DEVICE void push(float tv, int i, bool ok) {
    if constexpr (KB <= 8) {
#pragma unroll
      for (int s = 0; s < KB; ++s) {
        if (s == K) {
          t[s] = tv;
          pid[s] = i;
        }
      }
    } else {
      t[K] = tv;
      pid[K] = i;
    }
    valid.set(K, ok);
    ++K;
  }
};

// The member slots on the world-space ray (o, d).
template <int KB>
RRAY_DEVICE void member_slots(const Scene& s, V3 o, V3 d, MemberSlots<KB>* m) {
  float t[MAX_SLOTS];
  bool ok[MAX_SLOTS];
  m->K = 0;
  m->valid.clear();
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    m->t[k] = 0.0f;
    m->pid[k] = 0;
  }
  for (int i = 0; i < s.P(); ++i) {
    if (!s.member(i)) continue;
    const float* p = s.prim(i);
    const int n = slots_of<true>(s.kind(i), p, affine_pt(p, o),
                                 affine_vec(p, d), t, ok);
#pragma unroll
    for (int k = 0; k < MAX_SLOTS; ++k)
      if (k < n) m->push(t[k], i, ok[k]);
  }
}

// soa.csg_keeps (rray_tpu soa.py:814-857): per CSG, innermost first, a
// slot under it survives by the op's rule on the parities of the valid
// slots of each side that precede it in the stable sorted order (t_j <
// t_i, or t_j == t_i and j < i). Leaves the survivors in m->valid.
template <int KB>
RRAY_DEVICE void csg_filter(const Scene& s, MemberSlots<KB>* m) {
  constexpr int U = KB <= 8 ? KB : 1;  // unrolled when in registers
  const int K = m->K;
  // An invalid slot never survives (keep = valid && allowed), so its
  // pair loop is skipped, and a ray without a valid slot (most rays miss
  // the members) skips the filter.
  for (int ci = 0; ci < s.C() && m->valid.any(); ++ci) {
    const int op = s.csg_op(ci);
    const int* side = s.csg_side(ci);
    SlotBits<KB> keep;
    keep.clear();
#pragma unroll U
    for (int i = 0; i < KB; ++i) {
      if (i >= K) break;
      if (!m->valid.get(i)) continue;
      const int si = side[m->pid[i]];
      if (si == 0) {
        keep.set(i, true);
        continue;
      }
      bool inl = false, inr = false;
#pragma unroll U
      for (int j = 0; j < KB; ++j) {
        if (j >= K) break;
        const int sj = side[m->pid[j]];
        if (j == i || sj == 0) continue;
        const bool before = j < i ? m->t[j] <= m->t[i] : m->t[j] < m->t[i];
        const bool x = m->valid.get(j) && before;
        if (sj == 1) {
          inl = inl != x;
        } else {
          inr = inr != x;
        }
      }
      bool allowed;
      if (op == CSG_UNION) {
        allowed = si == 1 ? !inr : !inl;
      } else if (op == CSG_INTERSECTION) {
        allowed = si == 1 ? inr : inl;
      } else {  // CSG_DIFFERENCE
        allowed = si == 1 ? !inr : inl;
      }
      keep.set(i, allowed);
    }
    m->valid = keep;
  }
}

// ---- one Whitted node (rray_tpu whitted.py _node_row) --------------------

struct Node {
  V3 surface, over, under, reflectv, refr_dir;
  float refl_w, refr_w;
};

// Is [0, dist) on the shadow ray from `over` blocked by an analytic prim
// (first occluder ends the test) or, failing that, by the mesh? Under
// kExt a torus tests its slots, and the CSG members' slots on the
// segment are filtered first (rray_tpu whitted.py:1086-1128).
template <bool kExt, int KB>
RRAY_DEVICE bool blocked(const Scene& s, V3 over, V3 dir, float dist) {
  bool occ = false;
  for (int j = 0; j < s.P() && !occ; ++j) {
    const float* p = s.prim(j);
    const int kind = s.kind(j);
    if (KB > 0 && s.member(j)) continue;
    if (kExt && kind == TORUS) {
      float t[4];
      bool ok[4];
      torus_slots(affine_pt(p, over), affine_vec(p, dir), p[31], t, ok);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        occ = occ || (ok[k] && t[k] >= 0.0f && t[k] < dist);
      continue;
    }
    occ = occludes(kind, p, p + 21, over, dir, dist);
  }
  if constexpr (KB > 0) {
    if (!occ && s.C() > 0) {
      MemberSlots<KB> m;
      member_slots(s, over, dir, &m);
      csg_filter(s, &m);
      constexpr int U = KB <= 8 ? KB : 1;
#pragma unroll U
      for (int k = 0; k < KB; ++k) {
        if (k >= m.K || occ) break;
        occ = m.valid.get(k) && m.t[k] >= 0.0f && m.t[k] < dist;
      }
    }
  }
  if (!occ && s.T() > 0)
    occ = any_chunks(s.tris(), T_COLS, s.T(), s.tboxes(), s.at(D_CHUNKS),
                     MESH_CHUNK, over, dir, dist);
  return occ;
}

// Shadowed fraction of light li at `over`: binary for a point light; for
// an area light of level lv the share of its lv^2 jittered samples that
// are blocked, cnt * float(1/n) as rray_tpu whitted.py:1164 scales it.
// All path rows of a level draw with seeds[level, li].
template <bool kExt, int KB>
RRAY_DEVICE float shadow_frac(const Scene& s, int li, int level, V3 over) {
  const float* L = s.light(li);
  const int lv = s.level(li);
  if (lv == 0) {
    V3 to = v3(L[0] - over.x, L[1] - over.y, L[2] - over.z);
    float dist = sqrtf(dot(to, to));
    V3 dir = scale(to, 1.0f / fmaxf(dist, 1e-30f));
    return blocked<kExt, KB>(s, over, dir, dist) ? 1.0f : 0.0f;
  }
  const int n = lv * lv;
  const uint32_t hb = point_base(s.seed(level, li), over.x, over.y, over.z);
  float cnt = 0.0f;
  for (int k = 0; k < n; ++k) {
    V3 dir;
    float dist = area_sample(L + 6, hb, k, lv, over, &dir);
    cnt = cnt + (blocked<kExt, KB>(s, over, dir, dist) ? 1.0f : 0.0f);
  }
  return cnt * (float)(1.0 / n);
}

template <bool kExt, int KB>
RRAY_DEVICE Node node_eval(const Scene& s, Stack stk, V3 o, V3 d, int level) {
  const bool has_refl = s.at(D_REFL) != 0, has_refr = s.at(D_REFR) != 0;
  const int P = s.P();
  // Closest hit: per-prim minimum, then a strict < across prims, so the
  // lowest prim id wins ties; CSG members fold last (below).
  float best_t = INFINITY;
  int win = -1;
  float t[MAX_SLOTS];
  bool ok[MAX_SLOTS];
  for (int i = 0; i < P; ++i) {
    if (KB > 0 && s.member(i)) continue;
    const float* p = s.prim(i);
    slots_of<kExt>(s.kind(i), p, affine_pt(p, o), affine_vec(p, d), t, ok);
    float tp = INFINITY;
#pragma unroll
    for (int k = 0; k < MAX_SLOTS; ++k)
      tp = fminf(tp, (ok[k] && t[k] >= 0.0f) ? t[k] : INFINITY);
    if (tp < best_t) {
      best_t = tp;
      win = i;
    }
  }
  // The mesh fold after the analytic prims, bounded by their best t
  // (rray_tpu _mesh_closest): a mesh winner takes its group's prim row
  // and carries the interpolated vertex normal.
  V3 mesh_n = v3(0.0f, 0.0f, 0.0f);
  if (s.T() > 0) {
    TriHit m = closest_chunks(s.tris(), T_COLS, s.T(), s.tboxes(),
                              s.at(D_CHUNKS), MESH_CHUNK, o, d, best_t);
    if (m.t < best_t) {
      const float* g = s.tris() + m.idx * T_COLS;
      best_t = m.t;
      win = P + (int)g[18];
      mesh_n = hit_normal(g, m.u, m.v);
    }
  }
  // The CSG-filtered member slots, folded after the non-members and the
  // mesh with a strict < (rray_tpu whitted.py:902-924).
  if constexpr (KB > 0) {
    if (s.C() > 0) {
      MemberSlots<KB> m;
      member_slots(s, o, d, &m);
      csg_filter(s, &m);
      constexpr int U = KB <= 8 ? KB : 1;
#pragma unroll U
      for (int k = 0; k < KB; ++k) {
        if (k >= m.K) break;
        if (m.valid.get(k) && m.t[k] >= 0.0f && m.t[k] < best_t) {
          best_t = m.t[k];
          win = m.pid[k];
        }
      }
    }
  }
  Node out;
  if (win < 0) {  // miss: no light, dead children
    V3 z = v3(0.0f, 0.0f, 0.0f);
    out.surface = z;
    out.over = out.under = o;
    out.reflectv = d;
    out.refr_dir = v3(0.0f, 0.0f, 1.0f);
    out.refl_w = out.refr_w = 0.0f;
    return out;
  }
  const float* pw = s.prim(win);
  V3 point = add(o, scale(d, best_t));
  V3 eyev = neg(d);
  V3 normalv = normalize(
      win >= P ? mesh_n
               : nmat_vec(pw, local_normal_of<kExt>(s.kind(win), pw,
                                                    affine_pt(pw, point))));
  bool inside = dot(normalv, eyev) < 0.0f;
  normalv = scale(normalv, inside ? -1.0f : 1.0f);
  V3 over = add(point, scale(normalv, EPS_OFF));
  V3 under = sub(point, scale(normalv, EPS_OFF));

  // n1/n2: crossing-parity folds over every prim's slots (recomputed:
  // the same formulas give the same values as the closest-hit pass).
  float n1 = 1.0f, n2 = 1.0f;
  if (has_refr) {
    float t_hit = best_t;
    float tol = TOL * fmaxf(1.0f, fabsf(t_hit));
    float bts = -INFINITY, btl = -INFINITY, ior_s = 1.0f, ior_l = 1.0f;
    for (int i = 0; i < P; ++i) {
      const float* p = s.prim(i);
      slots_of<kExt>(s.kind(i), p, affine_pt(p, o), affine_vec(p, d), t, ok);
      int cnt_s = 0, cnt_l = 0;
      float last_s = -INFINITY, last_l = -INFINITY;
#pragma unroll
      for (int k = 0; k < MAX_SLOTS; ++k) {
        bool is_hit = (i == win) && (fabsf(t[k] - t_hit) <= tol);
        bool before = ok[k] && (t[k] < t_hit);
        bool in_s = before && !is_hit;
        bool in_l = before || (ok[k] && is_hit);
        cnt_s += in_s;
        last_s = fmaxf(last_s, in_s ? t[k] : -INFINITY);
        cnt_l += in_l;
        last_l = fmaxf(last_l, in_l ? t[k] : -INFINITY);
      }
      if ((cnt_s % 2) == 1 && last_s > bts) {
        bts = last_s;
        ior_s = p[30];
      }
      if ((cnt_l % 2) == 1 && last_l > btl) {
        btl = last_l;
        ior_l = p[30];
      }
    }
    n1 = (bts > -INFINITY && bts < INFINITY) ? ior_s : 1.0f;
    n2 = (btl > -INFINITY && btl < INFINITY) ? ior_l : 1.0f;
  }

  // Pattern at the over point, on the winner's object space; under kExt
  // an image leaf maps its points to uv on the winner's shape and reads
  // its texel in place.
  V3 base = eval_program<kExt>(s, stk, s.root(win), affine_pt(pw, over),
                               win < P ? s.kind(win) : -1, pw);

  // Phong per light (light.rs:98-140), shaded from the light's position
  // (an area light's centre), with its shadowed fraction.
  float amb = pw[24], dif = pw[25], spe = pw[26], shi = pw[27];
  V3 surface = v3(0.0f, 0.0f, 0.0f);
  for (int li = 0; li < s.L(); ++li) {
    const float* L = s.light(li);
    float unshadow = 1.0f - shadow_frac<kExt, KB>(s, li, level, over);
    V3 effective = v3(base.x * L[3], base.y * L[4], base.z * L[5]);
    V3 lightv = normalize(v3(L[0] - over.x, L[1] - over.y, L[2] - over.z));
    V3 ambient = scale(effective, amb);
    float ldn = dot(lightv, normalv);
    bool lit = ldn >= 0.0f;
    float dscale = lit ? dif * ldn : 0.0f;
    float rde = dot(reflect(neg(lightv), normalv), eyev);
    bool spec_on = lit && (rde > 0.0f);
    float factor = powf(fmaxf(rde, 1e-30f), shi);
    float sscale = spec_on ? spe * factor : 0.0f;
    surface.x = surface.x + ambient.x + (effective.x * dscale + L[3] * sscale) * unshadow;
    surface.y = surface.y + ambient.y + (effective.y * dscale + L[4] * sscale) * unshadow;
    surface.z = surface.z + ambient.z + (effective.z * dscale + L[5] * sscale) * unshadow;
  }

  // Refraction + TIR + Schlick (scene.rs:310-336, computations.rs:39-54).
  float reflective = pw[28], transparency = pw[29];
  float n_ratio = n1 / n2;
  float cos_i = dot(eyev, normalv);
  float sin2_t = n_ratio * n_ratio * (1.0f - cos_i * cos_i);
  bool tir = sin2_t > 1.0f;
  float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-30f));
  V3 direction = sub(scale(normalv, n_ratio * cos_i - cos_t), scale(eyev, n_ratio));
  bool live = !tir && (transparency > 0.0f);
  out.surface = surface;
  out.over = over;
  out.under = under;
  out.reflectv = reflect(d, normalv);
  out.refr_dir = live ? direction : v3(0.0f, 0.0f, 1.0f);
  out.refl_w = reflective;
  out.refr_w = live ? transparency : 0.0f;
  if (has_refl && has_refr && reflective > 0.0f && transparency > 0.0f) {
    float cos_eff = n1 > n2 ? cos_t : cos_i;
    float q = (n1 - n2) / (n1 + n2);
    float r0 = q * q;
    float m = 1.0f - cos_eff;
    float m2 = m * m;
    float m5 = m * (m2 * m2);
    float reflectance = r0 + (1.0f - r0) * m5;
    if (n1 > n2 && sin2_t > 1.0f) reflectance = 1.0f;
    out.refl_w = reflective * reflectance;
    out.refr_w = out.refr_w * (1.0f - reflectance);
  }
  return out;
}

// ---- the level scan for one primary ray (rray_tpu whitted.py _kernel) ----

// Path row: origin xyz, direction xyz, weight.
struct Row { float c[7]; };

RRAY_DEVICE Row make_row(V3 o, V3 d, float w) {
  Row r = {{o.x, o.y, o.z, d.x, d.y, d.z, w}};
  return r;
}

RRAY_DEVICE Row dead_row() {
  Row r = {{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f}};
  return r;
}

// Row r of a path-row array: for up to 4 rows by a select over constant
// indices (the array stays in registers), else by index.
template <int N>
RRAY_DEVICE Row get_row(const Row (&a)[N], int r) {
  if constexpr (N <= 4) {
    Row x = a[0];
#pragma unroll
    for (int k = 1; k < N; ++k)
      if (r == k) x = a[k];
    return x;
  } else {
    return a[r];
  }
}

template <int N>
RRAY_DEVICE void set_row(Row (&a)[N], int r, const Row& v) {
  if constexpr (N <= 4) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (r == k) a[k] = v;
  } else {
    a[r] = v;
  }
}

// Stable top-W by weight: odd-even transposition over the 2W child rows,
// swapping on a strict < (= lax.sort's tie order).
RRAY_DEVICE void swap_down(Row& a, Row& b) {
  if (a.c[6] < b.c[6]) {
    Row tmp = a;
    a = b;
    b = tmp;
  }
}

template <int W>
RRAY_DEVICE void sort_rows(Row (&ch)[2 * W]) {
  if constexpr (W <= 2) {  // unrolled: the rows stay in registers
#pragma unroll
    for (int rnd = 0; rnd < 2 * W; ++rnd) {
#pragma unroll
      for (int k = rnd % 2; k < 2 * W - 1; k += 2) swap_down(ch[k], ch[k + 1]);
    }
  } else {
    for (int rnd = 0; rnd < 2 * W; ++rnd) {
      for (int k = rnd % 2; k < 2 * W - 1; k += 2) swap_down(ch[k], ch[k + 1]);
    }
  }
}

// Spawn modes: both reflection and refraction -> 2W children + stable
// top-W; exactly one -> a width-1 chain (W == 1); neither -> one level.
// `stk` is the thread's pattern stack (as many frames as the scene's
// pattern programs push: kernels/whitted.py pattern_program).
template <int W, bool kExt, int KB>
RRAY_DEVICE void trace_ray(const Scene& s, Stack stk, V3 ro, V3 rd,
                           float* rgb) {
  const bool has_refl = s.at(D_REFL) != 0, has_refr = s.at(D_REFR) != 0;
  const int depth = s.at(D_DEPTH);
  const bool both = has_refl && has_refr;
  const int spawn = both ? 2 : ((has_refl || has_refr) ? 1 : 0);
  Row st[W];
  Row ch[2 * W];
  st[0] = make_row(ro, rd, 1.0f);
  for (int r = 1; r < W; ++r) st[r] = dead_row();
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int level = 0; level <= depth; ++level) {
    const int spawn_here = level == depth ? 0 : spawn;
#pragma unroll
    for (int r = 0; r < 2 * W; ++r) ch[r] = dead_row();
#pragma unroll 1  // one copy of the node's code, not W
    for (int r = 0; r < W; ++r) {
      const Row cur = get_row(st, r);
      float w = cur.c[6];
      if (w == 0.0f) continue;  // dead path row: contributes nothing
      V3 o = v3(cur.c[0], cur.c[1], cur.c[2]);
      V3 d = v3(cur.c[3], cur.c[4], cur.c[5]);
      Node nd = node_eval<kExt, KB>(s, stk, o, d, level);
      acc_r = acc_r + nd.surface.x * w;
      acc_g = acc_g + nd.surface.y * w;
      acc_b = acc_b + nd.surface.z * w;
      if (spawn_here == 2) {
        set_row(ch, r, make_row(nd.over, nd.reflectv, w * nd.refl_w));
        set_row(ch, W + r, make_row(nd.under, nd.refr_dir, w * nd.refr_w));
      } else if (spawn_here == 1) {
        ch[0] = has_refl ? make_row(nd.over, nd.reflectv, w * nd.refl_w)
                         : make_row(nd.under, nd.refr_dir, w * nd.refr_w);
      }
    }
    if (spawn_here == 2) {
      sort_rows<W>(ch);
#pragma unroll
      for (int r = 0; r < W; ++r) st[r] = ch[r];
    } else if (spawn_here == 1) {
      st[0] = ch[0];
    }
  }
  rgb[0] = acc_r;
  rgb[1] = acc_g;
  rgb[2] = acc_b;
}

}  // namespace rray
