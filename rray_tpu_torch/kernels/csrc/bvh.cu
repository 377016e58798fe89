// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/bvh.py::bvh_closest_triangle
// (closest hit, or bounded any-hit, over rray_tpu's implicit-heap LBVH
// of Morton-ordered leaves with sub-leaf boxes).
//
// What bounds it on an H100: compute and divergence. A ray reads 28 B
// and writes at most 40 B; the tree walk is a chain of dependent slab
// tests (~30 ops each) and each entered sub-leaf costs ~50 float ops per
// triangle, with a different path per ray. The TPU kernel walks one
// shared stack per 512-ray block and DMAs each entered leaf from HBM
// into VMEM; what it returns is what is ported, not that schedule:
//   * one thread per ray walks the heap with its own 32-entry stack
//     (the tree is at most 2048 leaves, depth 12), left child first as
//     on the TPU, and culls each node and sub-leaf box against
//     min(its own best t, dist); any-hit returns at its first hit;
//   * hits replace the best on (t, triangle index), so the lowest index
//     wins ties in any visit order;
//   * the triangle table (rows of 9-20 floats) and the box tables stay in
//     global memory behind the read-only cache; there is no leaf copy and
//     no padding of rays or triangles (padding leaves are skipped by
//     index, and row loops stop at T).
// Speed is not tuned yet: this is the simple, correct first port.
//
// Build: kernels/build.py (nvcc, sm_90a, -O3, --fmad=false).
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "mesh_device.cuh"

namespace {

constexpr int kThreads = 128;

// Outputs as closest_triangle_launch's (triangles.cu); any-hit writes
// t = 0 or +inf and zero u, v, idx.
__global__ void bvh_kernel(const float* __restrict__ rox,
                           const float* __restrict__ roy,
                           const float* __restrict__ roz,
                           const float* __restrict__ rdx,
                           const float* __restrict__ rdy,
                           const float* __restrict__ rdz,
                           const float* __restrict__ dist,
                           const float* __restrict__ tris, int ncols, int T,
                           const float* __restrict__ nodes,
                           const float* __restrict__ subs, int Lp, int leaf,
                           int subl, int any_hit, int normals, int n_aux,
                           float* __restrict__ fout, int* __restrict__ iout,
                           int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float limit = dist ? dist[i] : INFINITY;
  rray::TriHit h = rray::bvh_walk(tris, ncols, T, nodes, subs, Lp, leaf, subl,
                                  rray::v3(rox[i], roy[i], roz[i]),
                                  rray::v3(rdx[i], rdy[i], rdz[i]), limit,
                                  any_hit != 0);
  rray::write_hit(h, tris, ncols, normals != 0, n_aux, fout, iout, R, i);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `dist` may be null (no bound; any-hit needs it). nodes: [6, 2Lp];
// subs: [6, Lp * leaf / subl].
extern "C" int bvh_closest_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* dist, const float* tris,
    int ncols, int T, const float* nodes, const float* subs, int Lp, int leaf,
    int subl, int any_hit, int normals, int n_aux, float* fout, int* iout,
    int R, void* stream) {
  if (R <= 0) return 0;
  bvh_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      rox, roy, roz, rdx, rdy, rdz, dist, tris, ncols, T, nodes, subs, Lp,
      leaf, subl, any_hit, normals, n_aux, fout, iout, R);
  return static_cast<int>(cudaGetLastError());
}
