// CUDA ports of the Pallas TPU kernels
//   rray_tpu/kernels/triangles.py::closest_triangle  (closest hit)
//   rray_tpu/kernels/triangles.py::any_triangle      (shadow any-hit)
// over a Morton-ordered triangle table culled by boxes.
//
// What bounds them on an H100: bytes, by the count that matters (a ray
// reads 24 B and its bound, writes at most 40 B; the tables are read
// once), against ~50 float ops of Möller–Trumbore for each triangle whose
// own box a ray enters. What holds them far above that bound is the
// memory pipe: the loads of boxes and rows, and how many rows each lane
// tests. The TPU kernel lays a block of 512 rays across lanes, holds the
// whole table in VMEM and skips a chunk only when no ray of the block
// enters it; what it returns is what is ported, not that schedule:
//   * the tables are built once per scene (kernels/triangles.py
//     chunk_tables): geometry rows of p1 e1 e2 in 48 B (three 16-byte
//     loads), and 32 B box rows for the whole table, for chunks of rows
//     and for groups of triangles.GROUP rows inside each chunk, finer
//     than rray_tpu's 40-64-row chunks, which are the TPU's sublane
//     granularity; the winner's normal and payload come from the payload
//     table, read once after the fold;
//   * one thread per ray, and the 32 rays of a warp fold together
//     (mesh_device.cuh group_fold): each lane tests its ray against a
//     box, the warp votes, and an entered group's rows are read once for
//     the warp, a broadcast, and tested by the lanes that entered its
//     box. One thread per ray walking its own chunk list (the first
//     port's kernel) read a different row per lane where lanes
//     diverged, and tested every row of each chunk it entered;
//   * chunks, groups and rows go in index order with the box cull
//     against each lane's best t, so ties keep the lowest index, and
//     any-hit lanes stop at their first hit; the warp leaves when no lane
//     is live;
//   * where the block fits a block's shared memory (every mesh the fast
//     node sends here: fewer than 1024 triangles), a persistent grid of
//     one 1024-thread block per SM stages it once per block with bulk
//     asynchronous copies and its warps take 32-ray chunks from a
//     counter; otherwise a plain grid reads it through L1, so any T runs.
//
// Build: kernels/build.py (nvcc, sm_90a, -O3, --fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "mesh_device.cuh"
#include "stage_device.cuh"

namespace {

constexpr int kThreads = 256;         // the plain grid's block
constexpr int kStagedThreads = 1024;  // the persistent grid's block
constexpr size_t kSmemMax = 227 * 1024;

struct Args {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* bound;  // closest: t_init (may be null); any-hit: dist
  const float* block;  // chunk_tables' block, `words` floats
  int words, T, group, chunk;
  // Closest hit: the payload table [T, ncols] and the outputs (fout rows
  // t, u, v[, n xyz][, aux], iout the row); any-hit: hit[R].
  const float* tris;
  int ncols, normals, n_aux;
  float* fout;
  int* iout;
  int* hit;
  int R;
  int* counter;  // the persistent grid's next 32-ray chunk
};

// Ray i, where i < R; every lane of the warp calls it (the fold votes).
template <bool kAny>
__device__ __forceinline__ void trace(const Args& a, const float* block,
                                      int i) {
  const bool active = i < a.R;
  const int j = active ? i : 0;
  const float limit = a.bound ? a.bound[j] : INFINITY;
  const rray::TriHit h = rray::group_fold(
      block, a.T, a.group, a.chunk, rray::v3(a.ox[j], a.oy[j], a.oz[j]),
      rray::v3(a.dx[j], a.dy[j], a.dz[j]), limit, kAny, active);
  if (!active) return;
  if constexpr (kAny)
    a.hit[i] = h.t < INFINITY;
  else
    rray::write_hit(h, a.tris, a.ncols, a.normals != 0, a.n_aux, a.fout,
                    a.iout, a.R, i);
}

// kStaged: the persistent grid, the block staged in shared memory; else
// one ray per thread, the block read where it lies.
template <bool kAny, bool kStaged>
__device__ __forceinline__ void fold(const Args& a) {
  if constexpr (kStaged) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t bar;
    rray::stage_tables(smem, a.block, 4u * a.words, &bar);
    const int lane = threadIdx.x & 31;
    for (;;) {
      int base = 0;
      if (lane == 0) base = 32 * atomicAdd(a.counter, 1);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= a.R) return;
      trace<kAny>(a, smem, base + lane);
    }
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i - (int)(threadIdx.x & 31) >= a.R) return;  // the warp has no ray
    trace<kAny>(a, a.block, i);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStagedThreads : kThreads, 1)
    closest_kernel(const Args a) {
  fold<false, kStaged>(a);
}

template <bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStagedThreads : kThreads, 1)
    any_kernel(const Args a) {
  fold<true, kStaged>(a);
}

int launch(const Args& a, int staged, void (*plain)(Args),
           void (*persistent)(Args), void* stream) {
  if (a.R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    plain<<<(a.R + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * (size_t)a.words;
  if (smem > kSmemMax || a.words % 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      persistent, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, persistent, kStagedThreads, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaMemsetAsync(a.counter, 0, sizeof(int), s)) != cudaSuccess)
    return static_cast<int>(err);
  const int chunks = (a.R + 31) / 32;
  const int warps = kStagedThreads / 32;
  int grid = sms * per_sm;
  if (grid * warps > chunks) grid = (chunks + warps - 1) / warps;
  persistent<<<grid, kStagedThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` and return a CUDA error code (0 on
// success). Pointers are device pointers. block: chunk_tables' `words`
// floats for T rows in groups of `group` and chunks of `chunk`. With
// `staged` (and an int at `counter`, which the launch zeroes on the
// stream) the persistent grid stages the block in shared memory; it
// must fit.
extern "C" int closest_triangle_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* t_init,
    const float* block, int words, int T, int group, int chunk,
    const float* tris, int ncols, int normals, int n_aux, float* fout,
    int* iout, int R, int staged, int* counter, void* stream) {
  const Args a = {rox,  roy,   roz,     rdx,   rdy,  rdz,  t_init,
                  block, words, T,      group, chunk,
                  tris, ncols, normals, n_aux, fout, iout, nullptr,
                  R,    counter};
  return launch(a, staged, closest_kernel<false>, closest_kernel<true>,
                stream);
}

extern "C" int any_triangle_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* dist,
    const float* block, int words, int T, int group, int chunk, int* hit,
    int R, int staged, int* counter, void* stream) {
  const Args a = {rox,     roy, roz, rdx, rdy,     rdz,     dist,
                  block,   words, T,  group, chunk,
                  nullptr, 0,   0,   0,   nullptr, nullptr, hit,
                  R,       counter};
  return launch(a, staged, any_kernel<false>, any_kernel<true>, stream);
}
