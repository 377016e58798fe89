// Per-ray device code of the triangle kernels (triangles.cu, bvh.cu)
// and of the whitted kernel's in-kernel mesh (whitted_device.cuh).
//
// A triangle table is row-major [T, ncols]: p1 e1 e2 (columns 0-8), then,
// where the table carries them, the vertex normals n1 n2 n3 (9-17), then
// payload columns. One thread tests one ray against rows in index order;
// the threads of a warp that test the same row read one broadcast row.
// The in-kernel mesh's chunk boxes are component-major [6, n] (lo xyz, hi
// xyz), as rray_tpu lays them out for SMEM; the BVH kernel's tree and
// the triangle kernels' culled fold have their own layouts (below).
#pragma once

#include "vec_device.cuh"

namespace rray {

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

// ---- the BVH kernel's tree (kernels/bvh.py card_tables) -----------------
// rray_tpu's implicit heap over Morton-ordered leaves of `leaf` rows:
// node n's children are 2n and 2n + 1, the leaves are the nodes [Lp, 2Lp)
// and leaf c covers rows [(c - Lp) * leaf, + leaf) (the last live leaf
// fewer, up to T). Node rows are BVH_NODE floats, 64 B, four 16-byte
// loads: the x, y and z slabs of both children (left lo, left hi, right
// lo, right hi), then the children's live row counts as int32 bits. Row
// 0 holds the root's slabs in the left places. A child without rows
// (padding) has count 0 and is never entered, so no box is inverted.
// Walk rows are BVH_TRI floats, 48 B: p1 e1 e2 and three zeros.
constexpr int BVH_NODE = 16;
constexpr int BVH_TRI = 12;

// Slab test of one box (box_enter's expressions): entered in front of
// the ray and before `bound`; *tnear its entry t.
RRAY_DEVICE bool slab(float lx, float hx, float ly, float hy, float lz,
                      float hz, V3 o, V3 inv, float bound, float* tnear) {
  float tx1 = (lx - o.x) * inv.x;
  float tx2 = (hx - o.x) * inv.x;
  float ty1 = (ly - o.y) * inv.y;
  float ty2 = (hy - o.y) * inv.y;
  float tz1 = (lz - o.z) * inv.z;
  float tz2 = (hz - o.z) * inv.z;
  float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  *tnear = tmin;
  return tmin <= tmax && tmax >= 0.0f && tmin < bound;
}

// Child `side` (0 left, 1 right) of node row `row`, against `bound`.
RRAY_DEVICE bool child_enter(const float* row, int side, V3 o, V3 inv,
                             float bound) {
  float t;
  const int k = 2 * side;
  return slab(row[k], row[k + 1], row[4 + k], row[5 + k], row[8 + k],
              row[9 + k], o, inv, bound, &t);
}

// Votes of a warp's lanes: on the card every lane of a warp walks the
// BVH together (bvh_walk), on the host a walk is one lane.
#ifdef __CUDACC__
RRAY_DEVICE bool warp_any(bool x) { return __any_sync(0xffffffffu, x); }
RRAY_DEVICE int warp_count(bool x) {
  return __popc(__ballot_sync(0xffffffffu, x));
}
#else
RRAY_DEVICE bool warp_any(bool x) { return x; }
RRAY_DEVICE int warp_count(bool x) { return x ? 1 : 0; }
#endif

// Rows [r0, r1) of the walk table, for this lane where `on`, into h
// (closest: on (t, index), so the lowest index wins ties in any visit
// order). Returns whether some row has t < limit (any-hit: the lane is
// done).
RRAY_DEVICE bool leaf_rows(const float* walk, int r0, int r1, V3 o, V3 d,
                           float limit, bool any_hit, bool on, TriHit* h) {
  bool hit = false;
  for (int i = r0; i < r1; ++i) {
    const float* r = walk + (size_t)i * BVH_TRI;
    const F4 a = ld4(r), b = ld4(r + 4), c = ld4(r + 8);
    if (!on || (hit && any_hit)) continue;
    const float g[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    float u, v;
    const float t = mt(g, o, d, &u, &v);
    if (!(t < limit)) continue;
    hit = true;
    if (!any_hit && (t < h->t || (t == h->t && i < h->idx))) {
      h->t = t;
      h->u = u;
      h->v = v;
      h->idx = i;
    }
  }
  return hit;
}

// Closest hit with t < limit (any_hit: t = 0 at the first hit with
// t < limit) over the card's tree, for this lane where `active`. The
// lanes of a warp walk together: one visit reads a node row once for the
// warp (a broadcast), every lane tests its ray against both children's
// boxes, and the warp goes on to the children some lane enters, the one
// nearer for more lanes first; the other is marked in a 32-bit trail,
// one bit per depth, so the walk keeps no stack: in the implicit heap
// the pending node at depth k is the sibling of the current node's
// ancestor at that depth. A leaf's rows are read once for the warp and
// tested by the lanes that enter its box. Backtracking takes the deepest
// marked depth and tests that node's box again for every lane against
// its best t since (closest-hit). Boxes are culled per lane against
// min(its best t, limit); a lane tests a superset of the rows its own
// walk would, which changes no result.
RRAY_DEVICE TriHit bvh_walk(const float* nodes, const float* walk, int T,
                            int Lp, int leaf, V3 o, V3 d, float limit,
                            bool any_hit, bool active) {
  TriHit h = {INFINITY, 0.0f, 0.0f, 0};
  const V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  bool live = active && child_enter(nodes, 0, o, inv, limit);
  if (!warp_any(live)) return h;
  if (Lp == 1) {
    if (leaf_rows(walk, 0, T, o, d, limit, any_hit, live, &h) && any_hit)
      h.t = 0.0f;
    return h;
  }
  unsigned n = 1, cur = 1, trail = 0;
  for (;;) {
    // n: an internal node whose box some lane enters.
    const float* row = nodes + (size_t)n * BVH_NODE;
    const F4 x = ld4(row), y = ld4(row + 4), z = ld4(row + 8);
    const F4 m = ld4(row + 12);
    const float bound = fminf(h.t, limit);
    float t0, t1;
    const bool in0 = live && bits_int(m.x) > 0 &&
                     slab(x.x, x.y, y.x, y.y, z.x, z.y, o, inv, bound, &t0);
    const bool in1 = live && bits_int(m.y) > 0 &&
                     slab(x.z, x.w, y.z, y.w, z.z, z.w, o, inv, bound, &t1);
    const bool any0 = warp_any(in0), any1 = warp_any(in1);
    unsigned next = 0;
    bool enter = false;  // this lane enters `next`
    if (any0 && any1) {
      const bool right = warp_count(in1 && (!in0 || t1 < t0)) >
                         warp_count(in0 && (!in1 || t0 <= t1));
      next = 2 * n + (right ? 1u : 0u);
      enter = right ? in1 : in0;
      trail |= 1u << (top_bit(n) + 1);
    } else if (any0 || any1) {
      next = 2 * n + (any1 ? 1u : 0u);
      enter = any1 ? in1 : in0;
    }
    cur = n;
    // Test leaves and backtrack until an internal node is next.
    for (;;) {
      if (next >= (unsigned)Lp) {
        const int r0 = (int)(next - Lp) * leaf;
        const int r1 = r0 + leaf < T ? r0 + leaf : T;
        if (leaf_rows(walk, r0, r1, o, d, limit, any_hit, enter, &h) &&
            any_hit) {
          h.t = 0.0f;
          live = false;
        }
        if (!warp_any(live)) return h;
        cur = next;
      } else if (next != 0) {
        break;
      }
      next = 0;
      if (trail == 0) return h;
      const int k = top_bit(trail);
      trail &= ~(1u << k);
      const unsigned sib = (cur >> (top_bit(cur) - k)) ^ 1u;
      enter = live && child_enter(nodes + (size_t)(sib >> 1) * BVH_NODE,
                                  sib & 1u, o, inv, fminf(h.t, limit));
      if (warp_any(enter))
        next = sib;
      else
        cur = sib;
    }
    n = next;
  }
}

// ---- the triangle kernels' culled fold (kernels/triangles.py) --------
// One block of floats (chunk_tables): box rows of TRI_BOX floats, 32 B,
// two 16-byte loads (lo xyz, 0, hi xyz, 0): the whole table's box, then
// one per chunk of `chunk` rows, then one per group of `group` rows
// (`chunk` a multiple of `group`; the last chunk and group may be
// partial, and every box covers only the rows it has); then the T walk
// rows (BVH_TRI floats: p1 e1 e2 and three zeros).
constexpr int TRI_BOX = 8;

// Slab test of the box row at b (slab's expressions).
RRAY_DEVICE bool box_row(const float* b, V3 o, V3 inv, float bound) {
  const F4 lo = ld4(b), hi = ld4(b + 4);
  float t;
  return slab(lo.x, hi.x, lo.y, hi.y, lo.z, hi.z, o, inv, bound, &t);
}

// Closest hit with t < limit (any_hit: t = 0 at the first hit with
// t < limit) over the block, for this lane where `active`. The lanes of
// a warp fold together: every lane tests its ray against a box, against
// min(its best t, limit), and the warp goes into the box when some lane
// enters it; a group's rows are read once for the warp (a broadcast) and
// tested by the lanes that entered its box (leaf_rows). Chunks, groups
// and rows go in index order, and a lane skips a box only when it does
// not enter it before its best t, so every row a lane skips has a higher
// index than its best or lies behind it: the result is the exhaustive
// scan's. An any-hit lane is done at its first hit, and the warp leaves
// when no lane is live.
RRAY_DEVICE TriHit group_fold(const float* block, int T, int group,
                              int chunk, V3 o, V3 d, float limit,
                              bool any_hit, bool active) {
  TriHit h = {INFINITY, 0.0f, 0.0f, 0};
  const V3 inv = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  const int n_chunks = (T + chunk - 1) / chunk;
  const int n_groups = (T + group - 1) / group;
  const int per = chunk / group;
  const float* cbox = block + TRI_BOX;
  const float* gbox = cbox + (size_t)n_chunks * TRI_BOX;
  const float* rows = gbox + (size_t)n_groups * TRI_BOX;
  bool live = active && box_row(block, o, inv, limit);
  for (int c = 0; c < n_chunks && warp_any(live); ++c) {
    const bool in = live && box_row(cbox + (size_t)c * TRI_BOX, o, inv,
                                    fminf(h.t, limit));
    if (!warp_any(in)) continue;
    const int g1 = (c + 1) * per < n_groups ? (c + 1) * per : n_groups;
    for (int g = c * per; g < g1; ++g) {
      const bool on = in && live &&
                      box_row(gbox + (size_t)g * TRI_BOX, o, inv,
                              fminf(h.t, limit));
      if (!warp_any(on)) continue;
      const int r0 = g * group;
      const int r1 = r0 + group < T ? r0 + group : T;
      if (leaf_rows(rows, r0, r1, o, d, limit, any_hit, on, &h) &&
          any_hit) {
        h.t = 0.0f;
        live = false;
      }
    }
  }
  return h;
}

}  // namespace rray
