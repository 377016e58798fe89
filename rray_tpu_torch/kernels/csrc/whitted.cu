// CUDA port of the Pallas TPU kernel
//   rray_tpu/kernels/whitted.py::whitted_compact
// (pallas_call body `_kernel`, node `_node_row`): the whole compact
// Whitted wavefront for scenes of analytic sphere/plane/cube/cylinder/
// cone/torus prims, CSG over analytic operands and opaque triangle meshes
// of at most 1024 triangles, with point and area lights, cheap, noise,
// perturbed and image pattern trees: all five stages (a-e) of the TPU
// kernel.
//
// What bounds it on an H100: operations in divergent branches, and the
// machinery around them, not memory. A ray reads 24 B (origin, direction)
// and writes 12 B (RGB), then runs hundreds to thousands of scalar float
// ops per node: prim slot tests and shadow tests (stage a), W path rows
// and their top-W sort (b), level^2 shadow samples per area light (c),
// ~50 ops per triangle tested (d), a ~400-op quartic where a ray enters a
// torus's box, the CSG filter's slot-pair compares on every closest hit
// and shadow segment, Perlin octaves (e). Branches (which prim was hit,
// whether a row is alive or a segment blocked, which chunks or boxes a
// ray enters) differ between threads. The design, one thread per primary
// ray, answers each cost:
//   * registers, not local memory (the bound of stage e: 220-250
//     registers and 1-4 KB of stack per thread limited an SM to 8 warps,
//     and every pattern node and CSG slot was a local-memory access): the
//     scene is a __grid_constant__ descriptor (table offsets and counts,
//     read from the constant bank) and the staged tables; pattern trees
//     run as flat programs in one loop (whitted_device.cuh
//     eval_program), with a per-thread stack of at most 7 frames in
//     shared memory, sized per scene; CSG member slots are a
//     compile-time bucket KB (8: unrolled, in registers; 80: the general
//     form); path rows stay in registers for W <= 2; only the torus
//     quartic is a call, values in and values out; __launch_bounds__ per
//     instantiation from ptxas's report (min_blocks below);
//   * divergence at silhouettes: a block of 128 threads shades a 16x8
//     pixel tile of the raster, a warp an 8x4 sub-tile, so a warp's rays
//     hit the same prims and enter the same boxes far more often than a
//     32x1 raster strip (rray_tpu keeps 16x32 swizzled tiles for the same
//     reason); each thread reads and writes its ray at its own flat
//     index, and rays without a raster width keep row order;
//   * staging and balance: the grid is persistent (SMs x resident
//     blocks, from the occupancy calculator), and each block copies the
//     scene tables (prims and material groups, pattern rows and programs,
//     lights, ints, jitter seeds, the mesh and its chunk boxes: the mesh
//     measured faster there than behind L1) once into dynamic shared
//     memory with bulk asynchronous copies (cp.async.bulk, TMA's 1-D form)
//     completing on an mbarrier; above 48 KB the launch opts in to
//     Hopper's 227 KB. A tile's cost varies tenfold across a frame (sky,
//     floor, torus silhouette), so blocks take their next tile from an
//     atomic counter: a fixed stride measured 1.2-1.4x slower, the
//     slowest block's tiles setting the frame's end;
//   * the rest as before: dead path rows (weight 0) and mesh chunks the
//     ray does not enter before its best t are skipped; an area light's
//     samples are a loop in registers, their jitter hashed from the seed
//     and the shadow origin's bits (jitter_device.cuh); a torus solves its
//     quartic (quartic_device.cuh) only where the thread's own ray enters
//     its box; Perlin octaves run inline (noise_device.cuh); an image
//     leaf reads one texel from the flat texel table in global memory;
//   * no tensor cores or wgmma: the work is scalar and branchy.
//
// Build (kernels/build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false, five units of this file compiled in
// parallel (the kernels without stage e and the entry points; the
// stage-e kernels by RRAY_EXT_UNIT: W = 1 with KB = 8, W = 1 with KB =
// 80, W = 2 and 4, W = 8 to 32). --fmad=false keeps every product and sum
// rounded separately, as the plain PyTorch version rounds them, so the two
// agree bit for bit but for rsqrtf/powf ulps.
#include <cuda_runtime.h>
#include <stdint.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "stage_device.cuh"
#include "whitted_device.cuh"

namespace {

using rray::SceneDesc;

constexpr int kThreads = 128;  // a 16x8 tile; warp w the 8x4 sub-tile w
constexpr int kTileW = 16, kTileH = 8;

// Resident blocks per SM asked of ptxas (registers <= 65536 / (128 *
// blocks)), from its report of each instantiation without a bound: 1 for
// all. Unbounded, W = 1 fits 5 blocks (94 registers) without stage e and
// 4 (116) with it; asking 5 or 6 of the stage-e kernel spilled 80-204 B
// and was at most 1.7% faster or up to 6% slower.
template <int W, bool kExt, int KB>
constexpr int min_blocks() {
  return 1;
}

// Ray index of thread `t` of tile `tile`, or -1. With a raster width the
// tiles are 16x8 pixels in row-major tile order, warp w covering the 8x4
// sub-tile (w % 2, w / 2) and lane l its pixel (l % 8, l / 8); without
// one, tile k is rays [128 k, 128 k + 128) (kernels/whitted.py
// tile_ray_index mirrors this).
__device__ __forceinline__ int tile_ray(int tile, int t, int width, int R) {
  if (width <= 0) {
    const int i = tile * kThreads + t;
    return i < R ? i : -1;
  }
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int warp = t >> 5, lane = t & 31;
  const int x = (tile % tiles_x) * kTileW + (warp & 1) * 8 + (lane & 7);
  const int y = (tile / tiles_x) * kTileH + (warp >> 1) * 4 + (lane >> 3);
  const int i = y * width + x;
  return x < width && i < R ? i : -1;
}

__host__ __device__ inline int n_tiles(int width, int R) {
  if (width <= 0) return (R + kThreads - 1) / kThreads;
  const int rows = (R + width - 1) / width;
  return ((width + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH);
}

template <int W, bool kExt, int KB>
__global__ void __launch_bounds__(kThreads, (min_blocks<W, kExt, KB>()))
    whitted_kernel(const __grid_constant__ SceneDesc desc,
                   const float* __restrict__ tables,
                   const float* __restrict__ rox,
                   const float* __restrict__ roy,
                   const float* __restrict__ roz,
                   const float* __restrict__ rdx,
                   const float* __restrict__ rdy,
                   const float* __restrict__ rdz, float* __restrict__ out_r,
                   float* __restrict__ out_g, float* __restrict__ out_b,
                   int* __restrict__ counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  __shared__ int next[2];
  const int words = desc.w[rray::D_WORDS];
  rray::stage_tables(smem, tables, 4u * words, &bar);
  const rray::Scene s = {&desc, smem};
  const rray::Stack stk = {smem + words + threadIdx.x, kThreads};
  const int width = desc.w[rray::D_WIDTH], R = desc.w[rray::D_R];
  const int tiles = n_tiles(width, R);
  // Block b starts on tile b, then takes the next untaken tile from the
  // counter (dynamic: a tile's cost varies tenfold across the frame, and
  // a fixed stride left SMs idle behind the slowest). Thread 0 asks for
  // it when its own ray is done, while the other warps finish theirs: a
  // block that asked at the start of a slow tile would hold its next one
  // back and lengthen the frame's tail. next[] alternates so a slow
  // reader of one slot never sees the following write.
  int tile = blockIdx.x;
  for (int k = 0; tile < tiles; ++k) {
    const int i = tile_ray(tile, threadIdx.x, width, R);
    if (i >= 0) {
      float rgb[3];
      rray::trace_ray<W, kExt, KB>(s, stk, rray::v3(rox[i], roy[i], roz[i]),
                                   rray::v3(rdx[i], rdy[i], rdz[i]), rgb);
      out_r[i] = rgb[0];
      out_g[i] = rgb[1];
      out_b[i] = rgb[2];
    }
    if (threadIdx.x == 0) next[k & 1] = gridDim.x + atomicAdd(counter, 1);
    __syncthreads();
    tile = next[k & 1];
  }
}

}  // namespace

// One launch's arguments (host side): the descriptor, device pointers,
// the dynamic shared memory in bytes and the stream. With `query` the
// entry only reports resident blocks per SM.
struct WhittedLaunch {
  SceneDesc desc;
  const float* tables;
  const float* rays[6];
  float* out[3];
  int* counter;  // one zeroed device int: the next tile past the grid
  int smem;
  cudaStream_t stream;
  bool query;
  int* blocks_per_sm;
};

namespace {

template <int W, bool kExt, int KB>
int run(const WhittedLaunch& a) {
  auto kernel = whitted_kernel<W, kExt, KB>;
  cudaError_t err = cudaSuccess;
  if (a.smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         a.smem);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.blocks_per_sm) *a.blocks_per_sm = per_sm;
  if (a.query) return 0;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = n_tiles(a.desc.w[rray::D_WIDTH], a.desc.w[rray::D_R]);
  const int grid = sms * per_sm < tiles ? sms * per_sm : tiles;
  kernel<<<grid, kThreads, a.smem, a.stream>>>(
      a.desc, a.tables, a.rays[0], a.rays[1], a.rays[2], a.rays[3],
      a.rays[4], a.rays[5], a.out[0], a.out[1], a.out[2], a.counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef RRAY_EXT_UNIT
// A unit of stage-e kernels. They take most of the build, so build.py
// compiles this file four more times (RRAY_EXT_UNIT = 1 to 4) in parallel
// with the unit below, which holds the kernels without stage e and the
// entries. A CSG scene has no refraction, so it runs at W = 1; wider
// stage-e scenes carry no CSG code (KB = 0).
#define RRAY_CAT(a, b) a##b
#define RRAY_EXT_ENTRY(u) RRAY_CAT(whitted_ext_unit_, u)
extern "C" int RRAY_EXT_ENTRY(RRAY_EXT_UNIT)(int W, int KB,
                                            const WhittedLaunch* a) {
#if RRAY_EXT_UNIT == 1
  if (W == 1 && KB == 8) return run<1, true, 8>(*a);
#elif RRAY_EXT_UNIT == 2
  if (W == 1 && KB == 80) return run<1, true, 80>(*a);
#elif RRAY_EXT_UNIT == 3
  if (W == 2 && KB == 0) return run<2, true, 0>(*a);
  if (W == 4 && KB == 0) return run<4, true, 0>(*a);
#else
  if (W == 8 && KB == 0) return run<8, true, 0>(*a);
  if (W == 16 && KB == 0) return run<16, true, 0>(*a);
  if (W == 32 && KB == 0) return run<32, true, 0>(*a);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
extern "C" int whitted_ext_unit_1(int W, int KB, const WhittedLaunch* a);
extern "C" int whitted_ext_unit_2(int W, int KB, const WhittedLaunch* a);
extern "C" int whitted_ext_unit_3(int W, int KB, const WhittedLaunch* a);
extern "C" int whitted_ext_unit_4(int W, int KB, const WhittedLaunch* a);

namespace {

int dispatch(int W, int ext, int KB, const WhittedLaunch& a) {
  if (ext) {
    if (W == 1) return KB == 8 ? whitted_ext_unit_1(W, KB, &a)
                               : whitted_ext_unit_2(W, KB, &a);
    if (W <= 4) return whitted_ext_unit_3(W, KB, &a);
    return whitted_ext_unit_4(W, KB, &a);
  }
  switch (W) {
    case 1: return run<1, false, 0>(a);
    case 2: return run<2, false, 0>(a);
    case 4: return run<4, false, 0>(a);
    case 8: return run<8, false, 0>(a);
    case 16: return run<16, false, 0>(a);
    case 32: return run<32, false, 0>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream_ptr` and returns cudaGetLastError() (0
// on success). `desc` is the host array of rray::D_COUNT descriptor words
// (kernels/whitted.py kernel_tables); `tables` the device copy of the
// staged tables (desc[D_WORDS] words, 16-byte aligned); `texels` the flat
// texel table or null; ray and output pointers are device pointers of
// desc[D_R] floats; `counter` one device int that holds 0 (the tile
// scheduler's). `smem` is the dynamic shared memory in bytes: the
// tables and the pattern stacks, up to Hopper's opt-in limit of 227 KB
// per block (kernels/whitted.py checks). W is the path-row width, `ext`
// selects stage e, KB its CSG slot bucket (8, 80; 0 past W = 1). The
// launch's resident blocks per SM are written to *blocks_per_sm.
extern "C" int whitted_compact_launch(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, float* out_r, float* out_g,
    float* out_b, const float* tables, const int* desc, const float* texels,
    int* counter, int W, int ext, int KB, int smem, int* blocks_per_sm,
    void* stream_ptr) {
  WhittedLaunch a = {};
  for (int k = 0; k < rray::D_COUNT; ++k) a.desc.w[k] = desc[k];
  a.desc.texels = texels;
  a.tables = tables;
  const float* rays[6] = {rox, roy, roz, rdx, rdy, rdz};
  for (int k = 0; k < 6; ++k) a.rays[k] = rays[k];
  a.out[0] = out_r;
  a.out[1] = out_g;
  a.out[2] = out_b;
  a.counter = counter;
  a.smem = smem;
  a.stream = static_cast<cudaStream_t>(stream_ptr);
  a.blocks_per_sm = blocks_per_sm;
  if (a.desc.w[rray::D_R] <= 0) return 0;
  return dispatch(W, ext, KB, a);
}

// Resident blocks per SM of one instantiation at `smem` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative CUDA error code.
extern "C" int whitted_blocks_per_sm(int W, int ext, int KB, int smem) {
  WhittedLaunch a = {};
  int blocks = 0;
  a.smem = smem;
  a.query = true;
  a.blocks_per_sm = &blocks;
  const int rc = dispatch(W, ext, KB, a);
  return rc != 0 ? -rc : blocks;
}

extern "C" const char* whitted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
