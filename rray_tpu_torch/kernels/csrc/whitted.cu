// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/whitted.py::whitted_compact
// (pallas_call body `_kernel`, node `_node_row`): the whole compact
// Whitted wavefront for scenes of analytic sphere/plane/cube/cylinder/
// cone/torus prims, CSG over analytic operands and opaque triangle meshes
// of at most 1024 triangles, with point and area lights, cheap, noise,
// perturbed and image pattern trees: all five stages (a-e) of the TPU
// kernel.
//
// What bounds it on an H100: compute and divergence, not memory. A ray
// reads 24 B (origin, direction) and writes 12 B (RGB), and then runs
// hundreds to thousands of scalar float ops per node (tens of thousands
// with a mesh: ~50 per triangle tested) whose branches (which prim was
// hit, whether a path row is alive, shadowed or not, which mesh chunks
// the ray enters) differ between neighbouring threads. The design
// answers that simply:
//   * one thread per primary ray: the TPU kernel's (8, 512) VMEM
//     blocking and block-level pl.when skips become a per-thread loop
//     that skips dead path rows (weight exactly 0) and mesh chunks the
//     ray itself does not enter before its best t, which gives the same
//     output;
//   * the small scene tables (prims and one row per mesh material group
//     [P + G <= 24, 32], pattern nodes [N, 17], lights [L, 15], and the
//     int tables that replace the TPU kernel's trace-time statics: prim
//     kinds, pattern roots, pattern node types and children, light
//     levels, and the area lights' jitter seeds [depth + 1, L]) are staged
//     into shared memory once per block; the mesh table ([<= 1032, 19]
//     rows, 78 KB, more than the 48 KB of static shared memory) and its
//     chunk boxes stay in global memory behind the read-only cache, where
//     the threads of a warp that test the same triangle read one row;
//   * the path state (W rows x 7 floats, 2W children) lives in the
//     thread's registers/local memory for all depth+1 levels; W is a
//     template parameter (1, 2, 4, 8, 16, 32);
//   * an area light's level^2 shadow samples (stage c) run as a loop in
//     the thread: the jitter draws are hashed in registers from the seed
//     and the shadow origin's bits (jitter_device.cuh), as the TPU kernel
//     recomputes them, so no [2n, R] draw array is read;
//   * stage e is the template flag kExt, chosen per scene: the other
//     scenes run kernels without a line of it. A torus solves its quartic
//     (quartic_device.cuh) only in the threads whose own ray enters its
//     box (the TPU kernel's block-level pl.when becomes a per-thread
//     branch); a CSG's member slots sit in the thread's local memory with
//     valid bits in two 64-bit words, filtered innermost first on every
//     closest hit and shadow segment (csg_filter); Perlin octaves run in
//     registers (noise_device.cuh); an image leaf reads one texel from the
//     flat texel table in global memory and the tree evaluates with it in
//     place (the TPU kernel's affine completion outside the kernel worked
//     around Mosaic's gathers, which a thread's load does not need);
//   * no tensor cores, TMA or wgmma: the work is scalar and branchy.
// Speed is not tuned yet; this kernel is the simple, correct first port.
//
// Build (kernels/build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false, four units of this file compiled in
// parallel (the kernels without stage e and the entry point; the
// stage-e kernels by pairs of widths, -DRRAY_EXT_W=1, 4, 16).
// --fmad=false keeps every product and sum rounded separately, as the
// plain PyTorch version rounds them, so the two agree bit for bit but
// for rsqrtf/powf ulps.
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "whitted_device.cuh"

namespace {

using rray::SceneView;

template <int W, bool kExt>
__global__ void whitted_kernel(const float* __restrict__ rox,
                               const float* __restrict__ roy,
                               const float* __restrict__ roz,
                               const float* __restrict__ rdx,
                               const float* __restrict__ rdy,
                               const float* __restrict__ rdz,
                               float* __restrict__ out_r,
                               float* __restrict__ out_g,
                               float* __restrict__ out_b,
                               const float* __restrict__ prims, int P, int G,
                               const float* __restrict__ pats, int N,
                               const float* __restrict__ lights, int L,
                               const int* __restrict__ ints, int n_int,
                               const int* __restrict__ seeds, int n_seeds,
                               const float* __restrict__ tris, int T,
                               const float* __restrict__ tboxes, int n_chunks,
                               const float* __restrict__ texels, int C,
                               int R, int depth, bool has_refl,
                               bool has_refr) {
  extern __shared__ float smem[];
  const int n_prim = (P + G) * rray::P_COLS;
  const int n_pat = N * rray::PAT_COLS;
  const int n_light = L * rray::L_COLS;
  float* s_prims = smem;
  float* s_pats = s_prims + n_prim;
  float* s_lights = s_pats + n_pat;
  int* s_ints = reinterpret_cast<int*>(s_lights + n_light);
  int* s_seeds = s_ints + n_int;
  for (int k = threadIdx.x; k < n_prim; k += blockDim.x) s_prims[k] = prims[k];
  for (int k = threadIdx.x; k < n_pat; k += blockDim.x) s_pats[k] = pats[k];
  for (int k = threadIdx.x; k < n_light; k += blockDim.x) s_lights[k] = lights[k];
  for (int k = threadIdx.x; k < n_int; k += blockDim.x) s_ints[k] = ints[k];
  for (int k = threadIdx.x; k < n_seeds; k += blockDim.x) s_seeds[k] = seeds[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  rray::SceneView s;
  s.prims = s_prims;
  s.pats = s_pats;
  s.lights = s_lights;
  s.kinds = s_ints;
  s.roots = s_ints + P;
  s.ptype = s_ints + 2 * P + G;
  s.pa = s.ptype + N;
  s.pb = s.pa + N;
  s.levels = s.pb + N;
  s.seeds = s_seeds;
  s.tris = tris;
  s.tboxes = tboxes;
  s.P = P;
  s.L = L;
  s.T = T;
  s.n_chunks = n_chunks;
  // The kernels without stage e leave its fields unset: the view goes to
  // non-inlined pattern code by reference, so every field set is a store
  // to local memory per thread.
  if constexpr (kExt) {
    s.pmeta = s.levels + L;
    s.member = s.pmeta + 4 * N;
    s.csg_ops = s.member + P;
    s.csg_side = s.csg_ops + C;
    s.texels = texels;
    s.C = C;
  }
  float rgb[3];
  rray::trace_ray<W, kExt>(s, rray::v3(rox[i], roy[i], roz[i]),
                           rray::v3(rdx[i], rdy[i], rdz[i]), depth, has_refl,
                           has_refr, rgb);
  out_r[i] = rgb[0];
  out_g[i] = rgb[1];
  out_b[i] = rgb[2];
}

constexpr int kThreads = 128;

// The launch's arguments: those of whitted_compact_launch, with the
// stream as a cudaStream_t.
#define RRAY_PARAMS                                                         \
  const float *rox, const float *roy, const float *roz, const float *rdx,  \
      const float *rdy, const float *rdz, float *out_r, float *out_g,      \
      float *out_b, const float *prims, int P, int G, const float *pats,   \
      int N, const float *lights, int L, const int *ints, int n_int,       \
      const int *seeds, const float *tris, int T, const float *tboxes,     \
      int n_chunks, const float *texels, int C, int R, int depth,          \
      int has_refl, int has_refr, cudaStream_t stream
#define RRAY_ARGS                                                           \
  rox, roy, roz, rdx, rdy, rdz, out_r, out_g, out_b, prims, P, G, pats, N, \
      lights, L, ints, n_int, seeds, tris, T, tboxes, n_chunks, texels, C, \
      R, depth, has_refl, has_refr, stream

template <int W, bool kExt>
int launch(RRAY_PARAMS) {
  const int n_seeds = (depth + 1) * L;
  const size_t smem =
      sizeof(float) * ((P + G) * rray::P_COLS + N * rray::PAT_COLS +
                       L * rray::L_COLS + n_int + n_seeds);
  const dim3 grid((R + kThreads - 1) / kThreads);
  whitted_kernel<W, kExt><<<grid, kThreads, smem, stream>>>(
      rox, roy, roz, rdx, rdy, rdz, out_r, out_g, out_b, prims, P, G, pats,
      N, lights, L, ints, n_int, seeds, n_seeds, tris, T, tboxes, n_chunks,
      texels, C, R, depth, has_refl != 0, has_refr != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef RRAY_EXT_W
// A unit of stage-e kernels: widths RRAY_EXT_W and 2 * RRAY_EXT_W. The
// stage-e instantiations take most of the build, so build.py compiles
// this file three times (RRAY_EXT_W = 1, 4, 16) in parallel with the
// unit below, which holds the kernels without stage e and the entry.
#define RRAY_CAT(a, b) a##b
#define RRAY_EXT_LAUNCH(w) RRAY_CAT(whitted_ext_launch_, w)
extern "C" int RRAY_EXT_LAUNCH(RRAY_EXT_W)(int W, RRAY_PARAMS) {
  if (W == RRAY_EXT_W) return launch<RRAY_EXT_W, true>(RRAY_ARGS);
  if (W == 2 * RRAY_EXT_W) return launch<2 * RRAY_EXT_W, true>(RRAY_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
extern "C" int whitted_ext_launch_1(int W, RRAY_PARAMS);
extern "C" int whitted_ext_launch_4(int W, RRAY_PARAMS);
extern "C" int whitted_ext_launch_16(int W, RRAY_PARAMS);

// Launches the kernel on `stream_ptr` and returns cudaGetLastError() (0
// on success). All pointers are device pointers; `ints` [n_int] holds
// kinds[P], pattern roots[P + G], node types[N], child a rows[N], child b
// rows[N], light levels[L] (0: point light), and with `ext` (stage e) the
// pattern meta[N, 4], CSG member flags[P], CSG ops[C] and sides[C, P];
// `seeds` is the [depth + 1, L] jitter seed table (read only for area
// lights); `tris`/`tboxes` may be null when T = 0 (no mesh), `texels`
// when no pattern has an image. The tables must fit the 48 KB of shared
// memory a block gets without opt-in (kernels/whitted.py checks).
extern "C" int whitted_compact_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, float* out_r, float* out_g,
    float* out_b, const float* prims, int P, int G, const float* pats, int N,
    const float* lights, int L, const int* ints, int n_int, const int* seeds,
    const float* tris, int T, const float* tboxes, int n_chunks,
    const float* texels, int C, int R, int depth, int W, int has_refl,
    int has_refr, int ext, void* stream_ptr) {
  if (R <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ext) {
    if (W <= 2) return whitted_ext_launch_1(W, RRAY_ARGS);
    if (W <= 8) return whitted_ext_launch_4(W, RRAY_ARGS);
    return whitted_ext_launch_16(W, RRAY_ARGS);
  }
  switch (W) {
    case 1: return launch<1, false>(RRAY_ARGS);
    case 2: return launch<2, false>(RRAY_ARGS);
    case 4: return launch<4, false>(RRAY_ARGS);
    case 8: return launch<8, false>(RRAY_ARGS);
    case 16: return launch<16, false>(RRAY_ARGS);
    case 32: return launch<32, false>(RRAY_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* whitted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
