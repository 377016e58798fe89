// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/analytic.py::area_shadow_fraction
// (pallas_call body `_kernel`): for each shadow origin, how many of an
// area light's level^2 jittered samples are blocked by the scene's
// analytic prims (sphere/plane/cube/cylinder/cone). The torch fast node
// calls it for area lights in scenes without a mesh; the wrapper
// (kernels/analytic.py) divides the count by n, as rray_tpu's caller
// does, so the fraction equals the XLA sample loop's count / n.
//
// One deliberate difference from the TPU kernel's inputs: that kernel
// reads a [2n, R] array of draws; this one takes the int32 seed and
// hashes the draws in registers from it and the origin's float32 bits
// (jitter_device.cuh), as rray_tpu's whitted kernel does. Same draws,
// same function, and no draw array in device memory (2 * 25 floats per
// origin at level 5).
//
// What bounds it on an H100: operations, not memory. A thread reads 12 B
// and writes 4 B, then runs n samples of ~40 integer hash operations and
// ~20 float operations each, and per sample up to P occlusion tests of
// ~56 float operations (all P when the sample is open, fewer when an
// occluder ends the test early). The design:
//   * one thread per origin, the samples a loop in registers (the TPU
//     kernel's unrolled [BR] lane block becomes a thread);
//   * the prims' [P, 16] parameter rows, their kinds and the light's nine
//     floats staged in dynamic shared memory once per block, read by
//     every thread of a warp at the same address (a broadcast), while
//     they fit in the 48 KB a block gets without opting in (P <= 722);
//     past that the threads read them from global memory, where the
//     same broadcast reads hit L1, so any number of prims runs here;
//   * the first occluder ends a sample's prim loop;
//   * the per-origin body is `area_count` in whitted_device.cuh, built on
//     the whitted kernel's `occludes` (the 16-column rows keep
//     ymin/ymax/closed at 12-14) and `area_sample`, so both area kernels
//     run one copy of the predicate and the sample geometry, and the body
//     also compiles as host C++ for the CPU tests.
//
// Build (kernels/build.py): -O3 --fmad=false, never -use_fast_math: each
// product and sum rounds as in the plain PyTorch version.
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "whitted_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kSmemDefault = 48 * 1024;
using rray::A_COLS;

// kStaged: copy the tables into shared memory first; else read them
// where they lie in global memory.
template <bool kStaged>
__global__ void area_kernel(const float* __restrict__ ox,
                            const float* __restrict__ oy,
                            const float* __restrict__ oz,
                            const float* __restrict__ light,
                            const float* __restrict__ params,
                            const int* __restrict__ kinds, int P, int level,
                            int seed, float* __restrict__ count, int R) {
  if (kStaged) {
    extern __shared__ float smem[];
    float* s_params = smem;
    float* s_light = s_params + P * A_COLS;
    int* s_kinds = reinterpret_cast<int*>(s_light + 9);
    for (int k = threadIdx.x; k < P * A_COLS; k += blockDim.x) s_params[k] = params[k];
    for (int k = threadIdx.x; k < 9; k += blockDim.x) s_light[k] = light[k];
    for (int k = threadIdx.x; k < P; k += blockDim.x) s_kinds[k] = kinds[k];
    __syncthreads();
    params = s_params;
    light = s_light;
    kinds = s_kinds;
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  count[i] = rray::area_count(light, params, kinds, P, level, seed,
                              rray::v3(ox[i], oy[i], oz[i]));
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers: origins ox/oy/oz [R], the
// light's corner, uvec, vvec [9], the prims' parameter rows [P, 16] and
// kinds [P]; `count` [R] receives the number of blocked samples.
extern "C" int area_shadow_launch(const float* ox, const float* oy,
                                  const float* oz, const float* light,
                                  const float* params, const int* kinds,
                                  int P, int level, int seed, float* count,
                                  int R, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = sizeof(float) * (P * A_COLS + 9 + P);
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= kSmemDefault) {
    area_kernel<true><<<grid, kThreads, smem, s>>>(
        ox, oy, oz, light, params, kinds, P, level, seed, count, R);
  } else {
    area_kernel<false><<<grid, kThreads, 0, s>>>(
        ox, oy, oz, light, params, kinds, P, level, seed, count, R);
  }
  return static_cast<int>(cudaGetLastError());
}
