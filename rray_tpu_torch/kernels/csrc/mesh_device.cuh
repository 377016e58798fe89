// Per-ray device code of the triangle kernels (triangles.cu, bvh.cu)
// and of the whitted kernel's in-kernel mesh (whitted_device.cuh).
//
// A triangle table is row-major [T, ncols]: p1 e1 e2 (columns 0-8), then,
// where the table carries them, the vertex normals n1 n2 n3 (9-17), then
// payload columns. One thread tests one ray against rows in index order;
// the threads of a warp that test the same row read one broadcast row.
// Box tables are component-major [6, n] (lo xyz, hi xyz), as rray_tpu
// lays them out for SMEM.
#pragma once

#include "vec_device.cuh"

namespace rray {

constexpr int BVH_STACK = 32;  // heap depth <= log2(2048 leaves) + 1 = 12

struct TriHit {
  float t, u, v;  // t = +inf: no hit
  int idx;
};

// Zero-safe reciprocal of a direction component (rray_tpu _inv_dir).
RRAY_DEVICE float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d);
}

// Slab test (rray_tpu _ray_slab, cube.rs:48-61 form): does the ray enter
// box c of a [6, n] table in front of it and before `bound`? An inverted
// box (+inf lo, -inf hi) passes, as on the TPU: every caller bounds its
// triangle loop by T.
RRAY_DEVICE bool box_enter(const float* b, int n, int c, V3 o, V3 inv,
                           float bound) {
  float tx1 = (b[c] - o.x) * inv.x;
  float tx2 = (b[3 * n + c] - o.x) * inv.x;
  float ty1 = (b[n + c] - o.y) * inv.y;
  float ty2 = (b[4 * n + c] - o.y) * inv.y;
  float tz1 = (b[2 * n + c] - o.z) * inv.z;
  float tz2 = (b[5 * n + c] - o.z) * inv.z;
  float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return tmin <= tmax && tmax >= 0.0f && tmin < bound;
}

// Möller–Trumbore (triangle.rs:72-94) against table row g, in the plain
// version's expression order (kernels/triangles.py _tri_chunk_eval).
// Returns t, or +inf on a miss (t < 0 included); u, v always.
RRAY_DEVICE float mt(const float* g, V3 o, V3 d, float* uu, float* vv) {
  float e1x = g[3], e1y = g[4], e1z = g[5];
  float e2x = g[6], e2y = g[7], e2z = g[8];
  float cx = d.y * e2z - d.z * e2y;
  float cy = d.z * e2x - d.x * e2z;
  float cz = d.x * e2y - d.y * e2x;
  float det = e1x * cx + e1y * cy + e1z * cz;
  bool ok = fabsf(det) >= EPSILON;
  float f = 1.0f / (ok ? det : 1.0f);
  float sx = o.x - g[0];
  float sy = o.y - g[1];
  float sz = o.z - g[2];
  float u = f * (sx * cx + sy * cy + sz * cz);
  ok = ok && u >= 0.0f && u <= 1.0f;
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = f * (d.x * qx + d.y * qy + d.z * qz);
  ok = ok && v >= 0.0f && u + v <= 1.0f;
  float t = f * (e2x * qx + e2y * qy + e2z * qz);
  ok = ok && t >= 0.0f;
  *uu = u;
  *vv = v;
  return ok ? t : INFINITY;
}

// The winner's interpolated world vertex normal, unnormalized
// (smooth_triangle.rs:99-101; flat triangles store n1 = n2 = n3).
RRAY_DEVICE V3 hit_normal(const float* g, float u, float v) {
  float w1 = 1.0f - u - v;
  return v3(w1 * g[9] + u * g[12] + v * g[15],
            w1 * g[10] + u * g[13] + v * g[16],
            w1 * g[11] + u * g[14] + v * g[17]);
}

// Ray i's outputs: fout rows (R floats each) t, u, v, then nx, ny, nz
// when the table carries normals, then the n_aux payload columns that
// follow them in the table; iout the winning row. A miss writes t = +inf
// and zero payloads (u, v and idx are zero for it already).
RRAY_DEVICE void write_hit(TriHit h, const float* tris, int ncols,
                           bool normals, int n_aux, float* fout, int* iout,
                           int R, int i) {
  const bool found = h.t < INFINITY;
  const float* g = tris + (size_t)h.idx * ncols;
  fout[i] = h.t;
  fout[(size_t)R + i] = h.u;
  fout[(size_t)2 * R + i] = h.v;
  int row = 3;
  if (normals) {
    V3 n = hit_normal(g, h.u, h.v);
    fout[(size_t)3 * R + i] = found ? n.x : 0.0f;
    fout[(size_t)4 * R + i] = found ? n.y : 0.0f;
    fout[(size_t)5 * R + i] = found ? n.z : 0.0f;
    row = 6;
  }
  const int aux0 = normals ? 18 : 9;
  for (int k = 0; k < n_aux; ++k)
    fout[(size_t)(row + k) * R + i] = found ? g[aux0 + k] : 0.0f;
  iout[i] = h.idx;
}

// Closest hit with t < bound over a table culled in chunks of `chunk`
// rows (boxes [6, n_chunks + 1], the last column the whole table's box):
// a chunk is skipped when the ray does not enter its box before
// min(best t, bound). Rows fold in index order with a strict <, so ties
// keep the lowest index.
RRAY_DEVICE TriHit closest_chunks(const float* tris, int ncols, int T,
                                  const float* boxes, int n_chunks,
                                  int chunk, V3 o, V3 d, float bound) {
  TriHit h = {INFINITY, 0.0f, 0.0f, 0};
  V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  const int nb = n_chunks + 1;
  if (!box_enter(boxes, nb, n_chunks, o, inv, bound)) return h;
  for (int c = 0; c < n_chunks; ++c) {
    if (!box_enter(boxes, nb, c, o, inv, fminf(h.t, bound))) continue;
    const int end = (c + 1) * chunk < T ? (c + 1) * chunk : T;
    for (int i = c * chunk; i < end; ++i) {
      float u, v;
      float t = mt(tris + (size_t)i * ncols, o, d, &u, &v);
      if (t < h.t && t < bound) {
        h.t = t;
        h.u = u;
        h.v = v;
        h.idx = i;
      }
    }
  }
  return h;
}

// Shadow any-hit: some row with 0 <= t < dist? Exits at the first hit.
RRAY_DEVICE bool any_chunks(const float* tris, int ncols, int T,
                            const float* boxes, int n_chunks, int chunk,
                            V3 o, V3 d, float dist) {
  V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  const int nb = n_chunks + 1;
  if (!box_enter(boxes, nb, n_chunks, o, inv, dist)) return false;
  for (int c = 0; c < n_chunks; ++c) {
    if (!box_enter(boxes, nb, c, o, inv, dist)) continue;
    const int end = (c + 1) * chunk < T ? (c + 1) * chunk : T;
    for (int i = c * chunk; i < end; ++i) {
      float u, v;
      if (mt(tris + (size_t)i * ncols, o, d, &u, &v) < dist) return true;
    }
  }
  return false;
}

// Closest hit with t < limit (any_hit: t = 0 at the first hit with
// t < limit) over rray_tpu's implicit-heap BVH: node n's children are 2n
// and 2n + 1, leaves are the nodes [Lp, 2Lp) and leaf n covers rows
// [(n - Lp) * leaf, + leaf); node boxes [6, 2Lp], sub-leaf boxes every
// `subl` rows [6, Lp * leaf / subl]. The walk keeps its own stack and
// visits the left child first, as the TPU kernel does; a hit replaces
// the best on (t, index), so the lowest index wins ties in any order.
// Subtrees that hold no row (padding leaves) are skipped.
RRAY_DEVICE TriHit bvh_walk(const float* tris, int ncols, int T,
                            const float* nodes, const float* subs, int Lp,
                            int leaf, int subl, V3 o, V3 d, float limit,
                            bool any_hit) {
  TriHit h = {INFINITY, 0.0f, 0.0f, 0};
  V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  const int nn = 2 * Lp;
  const int ns = Lp * (leaf / subl);
  int stack[BVH_STACK];
  int sp = 0;
  stack[sp++] = 1;
  while (sp > 0) {
    const int n = stack[--sp];
    int first = n;  // leftmost leaf under n
    while (first < Lp) first <<= 1;
    if ((first - Lp) * leaf >= T) continue;
    if (!box_enter(nodes, nn, n, o, inv, fminf(h.t, limit))) continue;
    if (n < Lp) {
      stack[sp++] = 2 * n + 1;
      stack[sp++] = 2 * n;
      continue;
    }
    const int s0 = (n - Lp) * (leaf / subl);
    for (int s = s0; s < s0 + leaf / subl; ++s) {
      if (!box_enter(subs, ns, s, o, inv, fminf(h.t, limit))) continue;
      const int end = (s + 1) * subl < T ? (s + 1) * subl : T;
      for (int i = s * subl; i < end; ++i) {
        float u, v;
        float t = mt(tris + (size_t)i * ncols, o, d, &u, &v);
        if (!(t < limit)) continue;
        if (any_hit) {
          h.t = 0.0f;
          return h;
        }
        if (t < h.t || (t == h.t && i < h.idx)) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.idx = i;
        }
      }
    }
  }
  return h;
}

}  // namespace rray
