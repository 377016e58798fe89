// CUDA ports of the Pallas TPU kernels
//   rray_tpu/kernels/triangles.py::closest_triangle  (closest hit)
//   rray_tpu/kernels/triangles.py::any_triangle      (shadow any-hit)
// over a Morton-ordered triangle table culled by chunk AABBs.
//
// What bounds them on an H100: compute, not memory. A ray reads 24 B
// (plus 4 B of seed or distance) and writes at most 40 B; each triangle
// it tests costs ~50 float ops of Möller–Trumbore, and the chunks it
// enters depend on the ray, so neighbouring threads diverge at the
// culls. The TPU kernel lays a block of 512 rays across lanes and skips
// a chunk only when no ray of the block enters it; here:
//   * one thread per ray loops over the chunks in index order and skips
//     every chunk whose box it does not enter before its own best t (or
//     `dist`), then folds the chunk's rows with a strict < (ties keep the
//     lowest index); the any-hit kernel returns at its first hit;
//   * the triangle table stays in global memory as one row per triangle
//     (rows of 9-20 floats) behind the read-only cache: the threads of a
//     warp that test the same triangle read one broadcast row, and no
//     ray or triangle padding is needed (loops stop at R and T);
//   * payloads (the interpolated normal, the aux columns) are read once,
//     for the winner, after the fold.
// Speed is not tuned yet: this is the simple, correct first port.
//
// Build: kernels/build.py (nvcc, sm_90a, -O3, --fmad=false).
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "mesh_device.cuh"

namespace {

constexpr int kThreads = 128;

// fout rows: t, u, v, then nx, ny, nz when `normals`, then the aux
// columns (table columns 9 + 9 * normals onward); iout: the row index.
__global__ void closest_kernel(const float* __restrict__ rox,
                               const float* __restrict__ roy,
                               const float* __restrict__ roz,
                               const float* __restrict__ rdx,
                               const float* __restrict__ rdy,
                               const float* __restrict__ rdz,
                               const float* __restrict__ t_init,
                               const float* __restrict__ tris, int ncols,
                               int T, const float* __restrict__ boxes,
                               int n_chunks, int chunk, int normals,
                               int n_aux, float* __restrict__ fout,
                               int* __restrict__ iout, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const rray::V3 o = rray::v3(rox[i], roy[i], roz[i]);
  const rray::V3 d = rray::v3(rdx[i], rdy[i], rdz[i]);
  const float bound = t_init ? t_init[i] : INFINITY;
  rray::TriHit h =
      rray::closest_chunks(tris, ncols, T, boxes, n_chunks, chunk, o, d, bound);
  rray::write_hit(h, tris, ncols, normals != 0, n_aux, fout, iout, R, i);
}

__global__ void any_kernel(const float* __restrict__ rox,
                           const float* __restrict__ roy,
                           const float* __restrict__ roz,
                           const float* __restrict__ rdx,
                           const float* __restrict__ rdy,
                           const float* __restrict__ rdz,
                           const float* __restrict__ dist,
                           const float* __restrict__ tris, int ncols, int T,
                           const float* __restrict__ boxes, int n_chunks,
                           int chunk, int* __restrict__ hit, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  hit[i] = rray::any_chunks(tris, ncols, T, boxes, n_chunks, chunk,
                            rray::v3(rox[i], roy[i], roz[i]),
                            rray::v3(rdx[i], rdy[i], rdz[i]), dist[i]);
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success). Pointers are device pointers; `t_init` may be null (no
// bound). tris: [T, ncols] rows; boxes: [6, n_chunks + 1].
extern "C" int closest_triangle_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* t_init,
    const float* tris, int ncols, int T, const float* boxes, int n_chunks,
    int chunk, int normals, int n_aux, float* fout, int* iout, int R,
    void* stream) {
  if (R <= 0) return 0;
  closest_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      rox, roy, roz, rdx, rdy, rdz, t_init, tris, ncols, T, boxes, n_chunks,
      chunk, normals, n_aux, fout, iout, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int any_triangle_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* dist, const float* tris,
    int ncols, int T, const float* boxes, int n_chunks, int chunk, int* hit,
    int R, void* stream) {
  if (R <= 0) return 0;
  any_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      rox, roy, roz, rdx, rdy, rdz, dist, tris, ncols, T, boxes, n_chunks,
      chunk, hit, R);
  return static_cast<int>(cudaGetLastError());
}
