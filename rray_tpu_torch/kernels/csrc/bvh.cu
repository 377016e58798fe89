// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/bvh.py::bvh_closest_triangle
// (closest hit, or bounded any-hit, over rray_tpu's implicit-heap LBVH
// of Morton-ordered triangles).
//
// What bounds it on an H100: the memory pipe and latency, not bytes or
// operations. A ray reads 28 B and writes at most 40 B; its walk is a
// chain of dependent node visits (four 16-byte loads and two slab tests
// of ~30 ops each) and leaf visits (three 16-byte loads and ~50 float
// ops per triangle). The TPU kernel walks one shared stack per 512-ray
// block over 128-triangle leaves sized for its SMEM and DMAs each
// entered leaf into VMEM; what it returns is what is ported, not that
// schedule:
//   * the tree is built once per scene for the card (kernels/bvh.py
//     card_tables): rray_tpu's heap and Morton order with leaves of
//     bvh.LEAF triangles and no leaf cap; one 64 B node row holds both
//     children's boxes and live counts, padding subtrees are pruned at
//     build time, and the walk table keeps only p1 e1 e2 in 48 B rows
//     (the winner's normal and payload come from the payload table);
//   * one thread per ray, and the 32 rays of a warp walk the tree
//     together (mesh_device.cuh bvh_walk): a visit reads a node row once
//     for the warp, a broadcast, and every lane tests both children; the
//     warp walks the child more lanes find nearer first and marks the
//     other in a 32-bit trail, so the walk keeps no stack and no local
//     memory. One thread per ray walking alone read a different row per
//     lane: node visits took ~90% of its time (PERF.md). Camera rays and
//     the fast node's shadow rays of neighbouring pixels are coherent,
//     so the warp's union of paths stays close to one ray's;
//   * hits replace the best on (t, triangle index), so the lowest index
//     wins ties in any visit order, and any-hit returns at its first hit;
//   * where node and walk tables fit a block's shared memory, a
//     persistent grid of one 1024-thread block per SM stages them once
//     per block with bulk asynchronous copies and its warps take 32-ray
//     chunks from a counter (faster than reading them through L1, and
//     than 512-thread blocks; PERF.md); otherwise a plain grid reads them
//     through L1, so any mesh size runs.
//
// Build: kernels/build.py (nvcc, sm_90a, -O3, --fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "mesh_device.cuh"
#include "stage_device.cuh"

namespace {

constexpr int kThreads = 256;        // the plain grid's block
constexpr int kStagedThreads = 1024;  // the persistent grid's block
constexpr size_t kSmemMax = 227 * 1024;

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *dist;
};

// Ray i, where i < R; every lane of the warp calls it (the walk votes).
__device__ __forceinline__ void trace(const Rays& r, const float* nodes,
                                      const float* walk, int T, int Lp,
                                      int leaf, bool any_hit,
                                      const float* tris, int ncols,
                                      bool normals, int n_aux, float* fout,
                                      int* iout, int R, int i) {
  const bool active = i < R;
  const int j = active ? i : 0;
  const float limit = r.dist ? r.dist[j] : INFINITY;
  const rray::TriHit h = rray::bvh_walk(
      nodes, walk, T, Lp, leaf, rray::v3(r.ox[j], r.oy[j], r.oz[j]),
      rray::v3(r.dx[j], r.dy[j], r.dz[j]), limit, any_hit, active);
  if (active) rray::write_hit(h, tris, ncols, normals, n_aux, fout, iout, R, i);
}

// Outputs as closest_triangle_launch's (triangles.cu); any-hit writes
// t = 0 or +inf and zero u, v, idx. `block`: the node rows, then the
// walk rows (`node_words` floats in).
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(Rays rays, const float* __restrict__ block, int node_words,
               int T, int Lp, int leaf, int any_hit,
               const float* __restrict__ tris, int ncols, int normals,
               int n_aux, float* __restrict__ fout, int* __restrict__ iout,
               int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= R) return;  // the warp has no ray
  trace(rays, block, block + node_words, T, Lp, leaf, any_hit != 0, tris,
        ncols, normals != 0, n_aux, fout, iout, R, i);
}

__global__ void __launch_bounds__(kStagedThreads, 1)
    bvh_staged_kernel(Rays rays, const float* __restrict__ block,
                      int node_words, int words, int T, int Lp, int leaf,
                      int any_hit, const float* __restrict__ tris, int ncols,
                      int normals, int n_aux, float* __restrict__ fout,
                      int* __restrict__ iout, int R,
                      int* __restrict__ counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  rray::stage_tables(smem, block, 4u * words, &bar);
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = 32 * atomicAdd(counter, 1);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= R) return;
    trace(rays, smem, smem + node_words, T, Lp, leaf, any_hit != 0, tris,
          ncols, normals != 0, n_aux, fout, iout, R, base + lane);
  }
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// `dist` may be null (no bound; any-hit needs it). block: [words] floats,
// the Lp node rows (node_words = 16 Lp) then the T walk rows; tris: the
// payload table [T, ncols]. With `staged` (and a zeroed int at `counter`)
// the persistent grid stages the block in shared memory; it must fit.
extern "C" int bvh_closest_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* dist, const float* block,
    int node_words, int words, int T, int Lp, int leaf, int any_hit,
    const float* tris, int ncols, int normals, int n_aux, float* fout,
    int* iout, int R, int staged, int* counter, void* stream) {
  if (R <= 0) return 0;
  const Rays rays = {rox, roy, roz, rdx, rdy, rdz, dist};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    bvh_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        rays, block, node_words, T, Lp, leaf, any_hit, tris, ncols, normals,
        n_aux, fout, iout, R);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * (size_t)words;
  if (smem > kSmemMax || words % 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bvh_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, bvh_staged_kernel, kStagedThreads, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int chunks = (R + 31) / 32;
  const int warps = kStagedThreads / 32;
  int grid = sms * per_sm;
  if (grid * warps > chunks) grid = (chunks + warps - 1) / warps;
  bvh_staged_kernel<<<grid, kStagedThreads, smem, s>>>(
      rays, block, node_words, words, T, Lp, leaf, any_hit, tris, ncols,
      normals, n_aux, fout, iout, R, counter);
  return static_cast<int>(cudaGetLastError());
}
