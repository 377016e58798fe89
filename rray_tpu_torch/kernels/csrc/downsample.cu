// The box-filter AA downsample of a CLI frame, on the card: the aa x aa
// means of the aa-scaled raster that the render leaves on the device,
// before the copy to the host (api.render_scene, at aa > 1).
//
// It replaces no TPU kernel: rray_tpu copies the whole raster to the host
// and averages it there with numpy (rray_tpu/render/canvas.py:11-17). At
// config 5's 1920x1080 and aa = 5 that copy is the 622 MB raster and the
// host mean a strided pass over 51.84 M rays on one thread: together most
// of a CLI frame (PERF.md). Done here, the copy moves the 24.9 MB image
// and the host takes no mean. The wrapper and plain version are
// kernels/downsample.py.
//
// What bounds it on an H100: bytes. It reads each raster value once and
// writes each image value once, (aa^2 + 1) * oh * ow * 3 values: 647 MB
// at config 5's size, 0.19 ms at 3.35 TB/s; it makes aa^2 adds and one
// division per output value. The design:
//   * one thread per output value (pixel and channel), on a grid whose y
//     walks the output rows and whose x covers one output row's 3 * ow
//     values, so a warp holds 32 neighbouring values of one output row.
//     At each sample (dy, dx) its loads fall in ~11 pixels' span of one
//     raster row, and over dx they read that span whole: each raster row
//     comes from device memory once, through L1, with no shared memory;
//   * the sum stays in a register, over loops that take aa at run time:
//     instantiated for aa = 5 and 3, the kernel ran 0.3% and 9% faster
//     (under 2 us a frame; PERF.md), too little to keep one per aa;
//   * the body (box_mean in downsample_device.cuh) adds in numpy's order
//     and divides once, so the image equals canvas.downsample's bit for
//     bit, in float32 and float64; it also compiles as host C++ for the
//     CPU tests.
//
// Build (kernels/build.py): -O3 --fmad=false, never -use_fast_math, so the
// division stays IEEE division: 9 and 25 have no exact reciprocal.
#include <cuda_runtime.h>

#define RRAY_DEVICE __device__ __forceinline__
#define RRAY_NOINLINE __device__ __noinline__
#include "downsample_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    downsample_kernel(const T* __restrict__ raster, T* __restrict__ image,
                      int w, int oh, int ow, int aa) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;  // in an output row
  if (v >= 3 * ow) return;
  const int ox = v / 3, c = v - 3 * ox;
  for (int oy = blockIdx.y; oy < oh; oy += gridDim.y)
    image[3LL * ow * oy + v] = rray::box_mean(raster, oy, ox, c, w, aa);
}

template <typename T>
int launch(const T* raster, T* image, int w, int oh, int ow, int aa,
           cudaStream_t s) {
  const dim3 grid((3 * ow + kThreads - 1) / kThreads,
                  oh < kMaxGridY ? oh : kMaxGridY);
  downsample_kernel<T><<<grid, kThreads, 0, s>>>(raster, image, w, oh, ow,
                                                 aa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// raster: a contiguous device array of [h, w, 3] values, h >= oh * aa and
// w >= ow * aa (the rows and columns past the last whole block are not
// read); image: [oh, ow, 3] values of the same type, written whole. f64
// selects double for both, else float.
extern "C" int downsample_launch(const void* raster, void* image, int w,
                                 int oh, int ow, int aa, int f64,
                                 void* stream) {
  if (oh <= 0 || ow <= 0) return 0;
  if (aa < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch(static_cast<const double*>(raster),
                  static_cast<double*>(image), w, oh, ow, aa, s);
  return launch(static_cast<const float*>(raster),
                static_cast<float*>(image), w, oh, ow, aa, s);
}
