// The per-value body of the box-filter downsample kernel (downsample.cu):
// one value of the [oh, ow, 3] image from the aa x aa block of the
// aa-scaled [h, w, 3] raster under it.
//
// Like the other *_device.cuh headers it needs only the function-qualifier
// macros, so it also compiles as host C++ (tests/test_torch_downsample.py).
#pragma once

namespace rray {

// Channel c of output pixel (oy, ox), from a contiguous raster w pixels
// wide: the block's aa x aa samples added in T to +0.0, rows outer and
// columns inner, then divided once by aa * aa. numpy's mean(axis=(1, 3))
// of the reshaped raster (render/canvas.py::downsample) adds in that
// order, in the raster's dtype and from +0.0 (a block of -0.0 gives
// +0.0), so both give the same bits. The build rounds every add and the
// division on its own (--fmad=false, no fast math: `/` is IEEE division).
template <typename T>
RRAY_DEVICE T box_mean(const T* raster, int oy, int ox, int c, int w,
                       int aa) {
  const long long row = 3LL * w;  // values in one raster row
  const T* p = raster + (long long)oy * aa * row + 3LL * ox * aa + c;
  T sum = 0;
  for (int dy = 0; dy < aa; ++dy) {
    const T* q = p + dy * row;
    for (int dx = 0; dx < aa; ++dx) sum += q[3 * dx];
  }
  return sum / static_cast<T>(aa * aa);
}

}  // namespace rray
