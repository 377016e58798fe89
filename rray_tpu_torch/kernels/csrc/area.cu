// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/analytic.py::area_shadow_fraction
// (pallas_call body `_kernel`): for each shadow origin, how many of an
// area light's level^2 jittered samples are blocked by the scene's
// analytic prims (sphere/plane/cube/cylinder/cone). The torch fast node
// calls it for area lights in scenes without a mesh; the wrapper
// writes count / n (one division, rounded once, as the plain version's
// `vec.div` and rray_tpu's caller outside its kernel divide), so the
// fraction equals the XLA sample loop's count / n.
//
// One deliberate difference from the TPU kernel's inputs: that kernel
// reads a [2n, R] array of draws; this one takes the int32 seed and
// hashes the draws in registers from it and the origin's float32 bits
// (jitter_device.cuh), as rray_tpu's whitted kernel does. Same draws,
// same function, and no draw array in device memory (2 * 25 floats per
// origin at level 5).
//
// What bounds it on an H100: operations, not memory. A thread reads 12 B
// and writes 4 B, then draws n samples (~40 integer hash operations and
// ~30 float operations each) and tests them against up to P prims: per
// (origin, prim) the origin's object-space point (18 float ops), per
// open (sample, prim) the direction's transform and the slot test (~35).
// The kernels are built without FMA (ROADMAP C), and the FP32 peak counts
// an FMA as two operations, so this kernel can issue at most about half
// of its operation bound: the gain is in doing less work. The design:
//   * one thread per origin; the per-origin body is `area_count` in
//     whitted_device.cuh, prim-major: per chunk of 16 samples the segments
//     are drawn once into the thread's column of shared memory (16 B a
//     sample, one conflict-free 16-byte load), then each prim's
//     object-space origin (and a sphere's c term) is computed once and
//     tested against the chunk's still-open samples (a mask, one loop
//     body for all of them), until none is open. The TPU kernel's
//     sample-major loop transformed the origin again for every sample;
//     the (sample, prim) pairs tested are the same, so is the count.
//     Segments held in registers needed the loop over a chunk's samples
//     unrolled around every occluder kind's test, and that larger code
//     ran slower (PERF.md);
//   * a conservative cull: a bounded prim whose padded world box (host,
//     once per scene) misses the box of the origin and the light's
//     parallelogram blocks none of the origin's segments and is skipped;
//     planes and unbounded cylinders and cones are always tested;
//   * every lane of a warp stands on the same prim, so the kind branch is
//     uniform and the row read is a broadcast: the prims' [P, 16]
//     parameter rows, [P, 8] bounds and kinds and the light's nine floats
//     are staged in dynamic shared memory once per block while they fit
//     in the 48 KB a block gets without opting in beside the segments
//     (P <= 327); past that
//     the threads read them from global memory, where the same broadcast
//     reads hit L1, so any number of prims runs here;
//   * the predicate is the whitted kernel's (`occludes_local`, under
//     `occludes`; the 16-column rows keep ymin/ymax/closed at 12-14) and
//     so is the sample geometry (`area_sample`), and the body also
//     compiles as host C++ for the CPU tests.
//
// Build (kernels/build.py): -O3 --fmad=false, never -use_fast_math: each
// product and sum rounds as in the plain PyTorch version.
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "whitted_device.cuh"

namespace {

constexpr int kThreads = 64;
constexpr size_t kSmemDefault = 48 * 1024;
// The threads' sample segments (rray::area_count's `seg`).
constexpr size_t kSegBytes =
    sizeof(float) * rray::SEG_WORDS * rray::AREA_CHUNK * kThreads;
using rray::A_COLS;
using rray::B_COLS;

// kStaged: copy the tables into shared memory first; else read them
// where they lie in global memory.
template <bool kStaged>
__global__ void area_kernel(const float* __restrict__ ox,
                            const float* __restrict__ oy,
                            const float* __restrict__ oz,
                            const float* __restrict__ light,
                            const float* __restrict__ params,
                            const float* __restrict__ bounds,
                            const int* __restrict__ kinds, int P, int level,
                            int seed, float* __restrict__ frac, int R) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem + threadIdx.x * rray::SEG_WORDS;
  if (kStaged) {
    float* s_params = smem + kSegBytes / sizeof(float);
    float* s_bounds = s_params + P * A_COLS;
    float* s_light = s_bounds + P * B_COLS;
    int* s_kinds = reinterpret_cast<int*>(s_light + 9);
    for (int k = threadIdx.x; k < P * A_COLS; k += blockDim.x) s_params[k] = params[k];
    for (int k = threadIdx.x; k < P * B_COLS; k += blockDim.x) s_bounds[k] = bounds[k];
    for (int k = threadIdx.x; k < 9; k += blockDim.x) s_light[k] = light[k];
    for (int k = threadIdx.x; k < P; k += blockDim.x) s_kinds[k] = kinds[k];
    __syncthreads();
    params = s_params;
    bounds = s_bounds;
    light = s_light;
    kinds = s_kinds;
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  frac[i] = rray::area_count(light, params, bounds, kinds, P, level, seed,
                             rray::v3(ox[i], oy[i], oz[i]), seg, kThreads) /
            (float)(level * level);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers: origins ox/oy/oz [R], the
// light's corner, uvec, vvec [9], the prims' parameter rows [P, 16],
// bounds [P, 8] and kinds [P]; `frac` [R] receives the blocked share of
// the level^2 samples.
extern "C" int area_shadow_launch(const float* ox, const float* oy,
                                  const float* oz, const float* light,
                                  const float* params, const float* bounds,
                                  const int* kinds, int P, int level,
                                  int seed, float* frac, int R,
                                  void* stream) {
  if (R <= 0) return 0;
  const size_t smem =
      kSegBytes + sizeof(float) * (P * (A_COLS + B_COLS) + 9 + P);
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= kSmemDefault) {
    area_kernel<true><<<grid, kThreads, smem, s>>>(
        ox, oy, oz, light, params, bounds, kinds, P, level, seed, frac, R);
  } else {
    area_kernel<false><<<grid, kThreads, kSegBytes, s>>>(
        ox, oy, oz, light, params, bounds, kinds, P, level, seed, frac, R);
  }
  return static_cast<int>(cudaGetLastError());
}
